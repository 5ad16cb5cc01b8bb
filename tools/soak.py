#!/usr/bin/env python
"""soak — long synthetic flagship training with a mid-run kill/resume.

Drives tools/train.py on the flagship CNN-TDNN recipe (NG-SGD +
orthonormal constraint + dynamic loss scaling + exponential LR + JSONL
metrics + checkpointing), SIGKILLs it mid-epoch, resumes from the
checkpoint, and verifies:

  * the resumed run continues from the checkpointed step (no restart),
  * the objf/frame trajectory is continuous across the kill (the first
    resumed steps stay within the trailing pre-kill band — a broken
    optimizer/loss-scale/BN restore would snap the objective back),
  * the LR schedule position is preserved,
  * no NaN/skipped-step cascade after resume.

Writes WORKDIR/soak_result.json.  Usage:
    python tools/soak.py [--workdir /tmp/soak] [--epochs 4]
        [--kill-after-steps 25] [--batch 16]
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import _common  # noqa: F401
from _common import read_metrics
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/soak")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--per-file", type=int, default=96)
    ap.add_argument("--kill-after-steps", type=int, default=25,
                    help="SIGKILL the first run once metrics show this "
                         "many steps (mid-epoch)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--xconfig", default="configs/cnn_tdnn.xconfig")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (kill/resume continuity "
                         "is backend-independent; pair with a small "
                         "--xconfig/--pdfs)")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    py = sys.executable
    egs_dir = os.path.join(args.workdir, "egs")
    metrics = os.path.join(args.workdir, "metrics.jsonl")
    ckpt = os.path.join(args.workdir, "ckpt")
    log1 = os.path.join(args.workdir, "run1.log")
    log2 = os.path.join(args.workdir, "run2.log")

    if not os.path.exists(os.path.join(egs_dir, "cegs.1.ark")):
        subprocess.run(
            [py, os.path.join(repo, "tools", "make_synthetic_egs.py"),
             egs_dir, "--files", str(args.files),
             "--per-file", str(args.per_file), "--pdfs", str(args.pdfs),
             "--frames-in", "48", "--frames-out", "15",
             "--den-states", "256", "--den-topology", "phone-lm"],
            check=True)

    train_cmd = [
        py, os.path.join(repo, "tools", "train.py"),
        "--egs", os.path.join(egs_dir, "cegs.*.ark"),
        "--den-fst", os.path.join(egs_dir, "den.fst"),
        "--xconfig", os.path.join(repo, args.xconfig),
        "--pdfs", str(args.pdfs), "--epochs", str(args.epochs),
        "--batch", str(args.batch), "--lr", "1e-3", "--lr-final", "1e-4",
        "--momentum", "0.5", "--natural-gradient", "--loss-scaling",
        "--orthonormal-interval", "4", "--xent-regularize", "0.1",
        "--metrics", metrics, "--ckpt-dir", ckpt,
        "--ckpt-every", str(args.ckpt_every), "--log-every", "5",
        "--seed", "0",
    ] + (["--cpu"] if args.cpu else [])

    # ---- run 1: train until kill-after-steps, then SIGKILL ---------------
    if os.path.exists(metrics):
        os.unlink(metrics)
    # stale checkpoints from a previous soak invocation would poison both
    # runs (run 1's saves collide with newer steps; run 2 would "resume"
    # from the OLD run's final checkpoint)
    if os.path.exists(ckpt):
        import shutil
        shutil.rmtree(ckpt)
    with open(log1, "w") as log:
        p = subprocess.Popen(train_cmd, stdout=log,
                             stderr=subprocess.STDOUT)
        killed_at = None
        t0 = time.time()
        while p.poll() is None:
            time.sleep(5)
            steps = len(read_metrics(metrics))
            if steps >= args.kill_after_steps:
                p.send_signal(signal.SIGKILL)
                p.wait()
                killed_at = steps
                break
            if time.time() - t0 > 7200:
                p.kill()
                raise SystemExit("run 1 exceeded 2h before reaching "
                                 f"{args.kill_after_steps} steps")
        if killed_at is None:
            if p.returncode != 0:
                with open(log1) as f:
                    tail = "\n".join(f.read().splitlines()[-12:])
                raise SystemExit(
                    f"run 1 CRASHED (rc={p.returncode}) before the kill "
                    f"point:\n{tail}")
            raise SystemExit("run 1 finished before the kill point — "
                             "raise --epochs or lower --kill-after-steps")
    rows1 = read_metrics(metrics)
    pre_tail = [r["objf_per_frame"] for r in rows1[-8:]]
    pre_steps = [r["step"] for r in rows1]

    # ---- run 2: resume -----------------------------------------------------
    with open(log2, "w") as log:
        r = subprocess.run(train_cmd + ["--resume"], stdout=log,
                           stderr=subprocess.STDOUT, timeout=7200)
    if r.returncode != 0:
        with open(log2) as f:
            raise SystemExit("resume run failed:\n"
                             + "\n".join(f.read().splitlines()[-15:]))
    rows2 = read_metrics(metrics)
    new = [r for r in rows2 if r["step"] > max(pre_steps)]

    # the metrics file is appended: rows2 = run1's rows + run2's rows
    run2_rows = rows2[len(rows1):]
    first_run2_step = run2_rows[0]["step"] if run2_rows else 0
    last_ckpt_step = (max(pre_steps) // args.ckpt_every) * args.ckpt_every
    resumed_from = first_run2_step
    post_head = [r["objf_per_frame"] for r in new[:8]]
    lr_pre = {r["step"]: r["lr"] for r in rows1}
    lr_ok = all(abs(r["lr"] - lr_pre.get(r["step"], r["lr"])) < 1e-9
                for r in rows2 if r["step"] in lr_pre)

    # resumed from a RECENT checkpoint, not from scratch.  The SIGKILL
    # can race the checkpoint write at the kill step itself (observed:
    # killed at step 30, ckpt-30 not yet durable, resume correctly fell
    # back to ckpt-20) — so the resume point must be one past a
    # checkpoint boundary within TWO ckpt intervals of the kill, not
    # necessarily the newest boundary.
    no_restart = (first_run2_step > 0
                  and (first_run2_step - 1) % args.ckpt_every == 0
                  and first_run2_step > max(0, last_ckpt_step
                                            - 2 * args.ckpt_every))

    # replay fidelity: steps the resumed run re-trains (between its
    # checkpoint and the kill point) must reproduce run 1's objf EXACTLY
    # — same params, same restored RNG key, same fast-forwarded data
    # order, deterministic XLA.  A drifting replay means some piece of
    # training state (rng key, data position, BN stats, loss scale) is
    # not in the checkpoint; this is what caught the missing rng-key /
    # unused batches_consumed pair in r3.
    objf1 = {r["step"]: r["objf_per_frame"] for r in rows1}
    replayed = [r for r in run2_rows if r["step"] in objf1]
    replay_diffs = [abs(r["objf_per_frame"] - objf1[r["step"]])
                    for r in replayed]
    replay_exact = all(d == 0.0 for d in replay_diffs)

    lo = min(pre_tail) - 3.0 * (max(pre_tail) - min(pre_tail) + 0.02)
    hi = max(pre_tail) + 3.0 * (max(pre_tail) - min(pre_tail) + 0.02)
    continuity = (all(lo <= v <= hi for v in post_head)
                  and all(np.isfinite(v) for v in post_head)
                  and bool(post_head))

    result = {
        "killed_at_step": len(rows1),
        "last_ckpt_step": last_ckpt_step,
        "resumed_at_step": resumed_from,
        "resume_ok": 0 < resumed_from <= len(rows1) + 1,
        "no_restart": bool(no_restart),
        "replayed_steps": len(replayed),
        "replay_max_objf_diff": max(replay_diffs) if replay_diffs else 0.0,
        "replay_exact": bool(replay_exact),
        "pre_kill_tail_objf": pre_tail,
        "post_resume_head_objf": post_head,
        "continuity_band": [lo, hi],
        "continuity_ok": bool(continuity),
        "lr_schedule_preserved": bool(lr_ok),
        "final_objf": rows2[-1]["objf_per_frame"] if rows2 else None,
        "total_steps": len(rows2),
    }
    out = os.path.join(args.workdir, "soak_result.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    ok = (result["resume_ok"] and continuity and lr_ok and no_restart
          and replay_exact)
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
