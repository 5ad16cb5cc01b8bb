#!/usr/bin/env python
"""profile_host — per-slice timing of the HOST side of the production
training loop at flagship dims: when the full loop runs slower than the
device step, the difference is exposed host work, and this tool
attributes it.

Slices per B-example batch:
  parse      ark bytes -> Example (native C++ parser + lazy views)
  validate   dim checks + shuffle bookkeeping
  features   np.stack of features/ivectors/weights/deriv_weights
  fst->csr   per-example supervision FST -> CSR
  numgraph   build_numerator_batch padding/stacking
  place      jnp.asarray conversions (device_put dispatch; async)

Runs on the CPU backend by default (the device is not involved until
`place`, which is measured only with --place on the real backend).

Usage: python tools/profile_host.py [--egs-dir DIR] [--batch 128]
       [--frames-in 150] [--pdfs 3080] [--batches 8]
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import _common  # noqa: F401
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--egs-dir")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=150)
    ap.add_argument("--frames-out", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--place", action="store_true",
                    help="also time trainer-style jnp conversions on the "
                         "real backend (omit to stay CPU-only)")
    args = ap.parse_args()
    if not args.place:
        _common.force_cpu()

    egs_dir = args.egs_dir
    if egs_dir is None:
        egs_dir = tempfile.mkdtemp(prefix="egs_prof_")
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(__file__),
                                     "make_synthetic_egs.py"),
                        egs_dir, "--files", "2",
                        "--per-file", str(args.batch * (args.batches // 2 + 1)),
                        "--pdfs", str(args.pdfs),
                        "--frames-in", str(args.frames_in),
                        "--frames-out", str(args.frames_out)],
                       check=True, stdout=subprocess.DEVNULL)

    from kaldi_fp16_tpu.io.batch import bucket_key, make_batch
    from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu.io.sparse import fst_to_csr
    from kaldi_fp16_tpu.chain.graph import build_numerator_batch

    cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs)
    pattern = os.path.join(egs_dir, "cegs.*.ark")

    # -- slice 1+2: parse + validate (example intake) ------------------------
    dl = DataLoader(pattern, cfg)
    t0 = time.perf_counter()
    examples = []
    for ex in dl._shuffled():
        examples.append(ex)
        if len(examples) >= args.batch * args.batches:
            break
    parse_s = time.perf_counter() - t0
    n = len(examples)
    per_batch = args.batch
    if n < per_batch:
        raise SystemExit(f"--egs-dir yielded {n} examples < one "
                         f"--batch {per_batch}; point at a bigger set "
                         f"or lower --batch")

    buckets = {}
    for ex in examples:
        buckets.setdefault(bucket_key(ex), []).append(ex)
    groups = [v[i:i + per_batch] for v in buckets.values()
              for i in range(0, len(v) - per_batch + 1, per_batch)]
    if not groups:
        raise SystemExit(f"{n} examples never filled a homogeneous "
                         f"bucket of {per_batch}; lower --batch")

    # -- slice 3: feature/weight stacking ------------------------------------
    t0 = time.perf_counter()
    for g in groups:
        np.stack([ex.features for ex in g]).astype(np.float32)
        if g[0].ivector is not None:
            np.stack([ex.ivector[0] for ex in g]).astype(np.float32)
        np.asarray([ex.supervision.weight for ex in g], np.float32)
    feat_s = time.perf_counter() - t0

    # -- slice 4: fst -> csr -------------------------------------------------
    t0 = time.perf_counter()
    csrs_by_g = [[fst_to_csr(ex.supervision.fst) for ex in g]
                 for g in groups]
    csr_s = time.perf_counter() - t0

    # -- slice 5: numerator graph batch --------------------------------------
    t0 = time.perf_counter()
    for csrs in csrs_by_g:
        build_numerator_batch(csrs, max_states=cfg.max_fst_states,
                              max_arcs=cfg.max_fst_arcs)
    num_s = time.perf_counter() - t0

    # -- whole make_batch (cross-check: should ~= 3+4+5) ---------------------
    t0 = time.perf_counter()
    for g in groups:
        make_batch(g, max_fst_states=cfg.max_fst_states,
                   max_fst_arcs=cfg.max_fst_arcs)
    make_s = time.perf_counter() - t0

    nb = max(1, len(groups))
    audio_sec_per_batch = per_batch * args.frames_in / 100.0
    rows = {
        "examples": n, "batches_profiled": nb, "batch": per_batch,
        "parse_validate_ms_per_batch": round(parse_s / (n / per_batch) * 1e3, 1),
        "feature_stack_ms_per_batch": round(feat_s / nb * 1e3, 1),
        "fst_to_csr_ms_per_batch": round(csr_s / nb * 1e3, 1),
        "num_graph_ms_per_batch": round(num_s / nb * 1e3, 1),
        "make_batch_total_ms_per_batch": round(make_s / nb * 1e3, 1),
        "host_total_ms_per_batch": round(
            (parse_s / (n / per_batch) + make_s / nb) * 1e3, 1),
        "audio_sec_per_batch": audio_sec_per_batch,
    }
    rows["host_only_audio_sec_per_s"] = round(
        audio_sec_per_batch / (rows["host_total_ms_per_batch"] / 1e3), 1)

    if args.place:
        import jax
        import jax.numpy as jnp
        g0 = groups[0]
        b = make_batch(g0, max_fst_states=cfg.max_fst_states,
                       max_fst_arcs=cfg.max_fst_arcs)
        for _ in range(2):   # warm transfer path
            arrs = {k: jnp.asarray(v) for k, v in b.arrays().items()}
            jax.block_until_ready(arrs)
        t0 = time.perf_counter()
        for _ in range(4):
            arrs = {k: jnp.asarray(v) for k, v in b.arrays().items()}
            gg = b.num_graph
            ga = [jnp.asarray(x) for x in
                  (gg.arc_src, gg.arc_dst, gg.arc_pdf, gg.arc_logw,
                   gg.arc_mask, gg.start, gg.final_logw)]
            jax.block_until_ready((arrs, ga))
        rows["place_sync_ms_per_batch"] = round(
            (time.perf_counter() - t0) / 4 * 1e3, 1)

    import json
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
