#!/usr/bin/env python
"""abtest — numerics-mode convergence A/B.

Runs two identical synthetic flagship-recipe trainings (same data, same
seeds, same schedule) differing ONLY in one numerics mode, then compares
the objf trajectories and final objectives.  This is the vetting the
reference applied to its atomic-vs-deterministic CUDA kernels (ref:
chain_det.cu:1-10, cmd/chainbench — drift quantified, then the fast
path promoted), applied at the training-trajectory level.

Modes (--ab):
  den-mode  exact (bf16x3 parity class) vs fast (single-pass bf16)
            denominator — REVOKED at flagship scale r3 (0.13 objf drift)
  bn-lowp   fp32-upcast batchnorm vs bf16 BN with fp32-accumulated
            stats (+16% step throughput at flagship B=128)
  grid      full-rate post-CNN stack ("exact" arm) vs frame-grid
            subsampling ("fast" arm; models/network.py grid_layers) —
            two legitimate semantics (grid BN stats = real Kaldi's
            compiled computation); vets convergence equivalence

Usage: python tools/abtest.py [--ab den-mode|bn-lowp] [--workdir ...]
           [--epochs 6] [--batch 16] [--pdfs 96] [--cpu]
Writes WORKDIR/ab_result.json and prints a markdown table.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import _common  # noqa: F401
from _common import read_metrics


def run(cmd, log_path):
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT)
    if r.returncode != 0:
        with open(log_path) as f:
            tail = f.read().splitlines()[-15:]
        raise SystemExit(f"command failed: {' '.join(cmd)}\n"
                         + "\n".join(tail))
    return time.perf_counter() - t0


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", default="den-mode",
                    choices=["den-mode", "bn-lowp", "grid", "feats-bf16"],
                    help="which numerics mode to A/B (see module doc)")
    ap.add_argument("--workdir", default="/tmp/abtest")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pdfs", type=int, default=96)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--per-file", type=int, default=32)
    ap.add_argument("--den-states", type=int, default=96)
    ap.add_argument("--frames-in", type=int, default=48,
                    help="synthetic chunk length (150 = production; the "
                         "bf16 drift this A/B vets grows with the den "
                         "scan length = frames-out)")
    ap.add_argument("--frames-out", type=int, default=15)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="run both trainings on the CPU backend (the A/B "
                         "is a NUMERICS comparison, valid on any backend)")
    ap.add_argument("--xconfig", default=None,
                    help="default: a small tdnnf recipe written into "
                         "workdir")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init/shuffle) for BOTH arms — "
                         "run several seeds to separate a real "
                         "trajectory effect from seed noise")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="synthetic-egs generation seed (new workdir "
                         "per data seed, or the cached egs are reused)")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    egs_dir = os.path.join(args.workdir, "egs")
    py = sys.executable
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    if not os.path.exists(os.path.join(egs_dir, "cegs.1.ark")):
        run([py, os.path.join(repo, "tools", "make_synthetic_egs.py"),
             egs_dir, "--files", str(args.files),
             "--per-file", str(args.per_file), "--pdfs", str(args.pdfs),
             "--den-states", str(args.den_states),
             "--frames-in", str(args.frames_in),
             "--frames-out", str(args.frames_out),
             "--seed", str(args.data_seed),
             "--den-topology", "phone-lm"],
            os.path.join(args.workdir, "egs.log"))

    xconfig = args.xconfig
    if xconfig is None:
        xconfig = os.path.join(args.workdir, "model.xconfig")
        with open(xconfig, "w") as f:
            f.write(f"""\
input name=input dim=40
linear-component name=linear1 dim=96
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=96 bottleneck-dim=32 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=96 bottleneck-dim=32 time-stride=1 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=48 big-dim=96
output-layer name=output dim={args.pdfs} include-log-softmax=false
""")

    # (baseline_name, candidate_name) and the extra train.py flags each
    # arm adds on top of the shared command line
    arms = {"den-mode": (("exact", ["--den-mode", "exact"]),
                         ("fast", ["--den-mode", "fast"])),
            "bn-lowp": (("exact", []),
                        ("fast", ["--bn-lowp"])),
            # full-rate (pre-r4) vs frame-grid subsampling.  Unlike the
            # two numerics A/Bs this compares two LEGITIMATE model
            # semantics (grid BN stats = what real Kaldi computes); the
            # question is convergence equivalence, not drift.
            "grid": (("exact", ["--no-grid"]),
                     ("fast", [])),
            # fp32 vs bf16 feature upload: inputs are consumed in bf16
            # either way, so this vets the input-rounding placement
            # (host vs first matmul) — r5 production-loop lever
            "feats-bf16": (("exact", []),
                           ("fast", ["--feats-bf16"]))}[args.ab]

    result = {"config": vars(args), "runs": {}}
    for mode, extra in arms:
        metrics = os.path.join(args.workdir, f"metrics_{mode}.jsonl")
        if os.path.exists(metrics):
            os.unlink(metrics)
        wall = run(
            [py, os.path.join(repo, "tools", "train.py"),
             "--egs", os.path.join(egs_dir, "cegs.*.ark"),
             "--den-fst", os.path.join(egs_dir, "den.fst"),
             "--xconfig", xconfig, "--pdfs", str(args.pdfs),
             "--epochs", str(args.epochs), "--batch", str(args.batch),
             "--lr", str(args.lr), "--momentum", "0.5",
             "--metrics", metrics,
             "--seed", str(args.seed)] + extra
            + (["--cpu"] if args.cpu else []),
            os.path.join(args.workdir, f"train_{mode}.log"))
        rows = [r for r in read_metrics(metrics) if "objf_per_frame" in r]
        result["runs"][mode] = {
            "wall_s": round(wall, 1),
            "steps": len(rows),
            "objf_trajectory": [round(r["objf_per_frame"], 6)
                                for r in rows],
            "final_objf": rows[-1]["objf_per_frame"] if rows else None,
        }

    ex = result["runs"]["exact"]["objf_trajectory"]
    fa = result["runs"]["fast"]["objf_trajectory"]
    n = min(len(ex), len(fa))
    diffs = [abs(a - b) for a, b in zip(ex[:n], fa[:n])]
    result["max_abs_objf_diff"] = max(diffs) if diffs else None
    result["final_objf_diff"] = (abs(ex[-1] - fa[-1])
                                 if ex and fa else None)

    out_path = os.path.join(args.workdir, "ab_result.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)

    print("| step | exact objf/frame | fast objf/frame | diff |")
    print("|---|---|---|---|")
    marks = sorted(set([0, n // 4, n // 2, 3 * n // 4, n - 1]))
    for i in marks:
        if 0 <= i < n:
            print(f"| {i + 1} | {ex[i]:.5f} | {fa[i]:.5f} | "
                  f"{abs(ex[i] - fa[i]):.2e} |")
    print(json.dumps({
        "metric": {"den-mode": "den_fast_mode_ab",
                   "bn-lowp": "bn_lowp_ab",
                   "grid": "grid_subsample_ab",
                   "feats-bf16": "feats_bf16_ab"}[args.ab],
        "final_objf_exact": ex[-1] if ex else None,
        "final_objf_fast": fa[-1] if fa else None,
        "final_objf_diff": result["final_objf_diff"],
        "max_abs_objf_diff": result["max_abs_objf_diff"],
        "wall_exact_s": result["runs"]["exact"]["wall_s"],
        "wall_fast_s": result["runs"]["fast"]["wall_s"],
    }))


if __name__ == "__main__":
    main()
