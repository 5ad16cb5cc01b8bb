#!/usr/bin/env python
"""traintest — end-to-end training smoke + throughput benchmark
(ref: cmd/traintest/main.go: loss must decrease over N steps).

Trains the flagship (or a given) xconfig on synthetic cegs data and reports
steps/s, frames/s and audio-seconds/s (frames at the standard 100 fps).

Usage: python tools/traintest.py [--egs-dir DIR] [--steps 20] [--xconfig PATH]
       (generates synthetic data into a temp dir when --egs-dir is omitted)
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--egs-dir")
    ap.add_argument("--xconfig")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--frames-in", type=int, default=48,
                    help="synthetic chunk length (150 = production scale; "
                         "only used when --egs-dir is not given)")
    ap.add_argument("--frames-out", type=int, default=15)
    ap.add_argument("--den-topology", choices=["egs", "phone-lm"],
                    default="egs",
                    help="egs = den.fst from the egs dir (default); "
                         "phone-lm = make_phone_lm_den_fst(num_pdfs) at "
                         "production scale (7052 states / ~113K arcs at "
                         "pdfs=3080) — the exact graph bench.py times, so "
                         "the production Trainer's step_ms is directly "
                         "comparable to the raw-loop bench")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--no-grid", action="store_true",
                    help="disable frame-grid subsampling (A/B hook)")
    ap.add_argument("--bench-json", action="store_true",
                    help="emit one benchmark JSON line at the end")
    ap.add_argument("--feats-bf16", action="store_true",
                    help="cast features to bfloat16 ON HOST before "
                         "upload: halves the dominant H2D buffer and "
                         "the transfer-serialization CPU.  The "
                         "network computes in bf16 anyway, so the only "
                         "numerics delta is input rounding happening "
                         "before instead of at the first matmul "
                         "(measurement hook; promote only via A/B)")
    ap.add_argument("--loader-workers", type=int, default=0,
                    help="feed batches from N OS-process workers "
                         "(ProcessLoader) instead of the in-line "
                         "DataLoader.  Even on a 1-core host this can "
                         "win in the TRAINING loop: the worker parses "
                         "and assembles on the CPU that otherwise idles "
                         "while the device executes the step, and the "
                         "main process's dispatch thread never fights "
                         "the GIL (the r3 thread-prefetch failure mode)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (numerics smoke; perf "
                         "numbers meaningless)")
    args = ap.parse_args()
    if args.cpu:
        _common.force_cpu()

    egs_dir = args.egs_dir
    if egs_dir is None:
        egs_dir = tempfile.mkdtemp(prefix="egs_")
        # one full pass must cover the bench (a ProcessLoader restart
        # costs a 'spawn' process launch mid-measurement)
        per_file = args.batch * max(4, args.steps // 2 + 3)
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(__file__),
                                     "make_synthetic_egs.py"),
                        egs_dir, "--files", "2", "--per-file",
                        str(per_file), "--pdfs", str(args.pdfs),
                        "--frames-in", str(args.frames_in),
                        "--frames-out", str(args.frames_out)],
                       check=True)

    import jax
    from kaldi_fp16_tpu.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu.io.fst import read_fst_file
    from kaldi_fp16_tpu.models.model import build_model, build_model_from_string
    from kaldi_fp16_tpu.training.train_step import TrainConfig
    from kaldi_fp16_tpu.training.trainer import Trainer

    if args.xconfig:
        model = build_model(args.xconfig)
    else:
        model = build_model_from_string(f"""\
input name=ivector dim=100
input name=input dim=40
linear-component name=linear1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=256
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=256 bottleneck-dim=64 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=256 bottleneck-dim=64 time-stride=3 bypass-scale=0.66
tdnnf-layer name=tdnnf3 dim=256 bottleneck-dim=64 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=64 big-dim=256
output-layer name=output dim={args.pdfs} include-log-softmax=false
""")
    print(model.summary())

    if args.den_topology == "phone-lm":
        from kaldi_fp16_tpu.chain.graph import make_phone_lm_den_fst
        den_fst = make_phone_lm_den_fst(num_pdfs=args.pdfs)
    else:
        den_fst = read_fst_file(os.path.join(egs_dir, "den.fst"))
    den_graph = DenominatorGraph.from_fst(den_fst, args.pdfs)
    den = DenominatorComputation(den_graph, leaky=1e-5)

    config = TrainConfig(learning_rate=args.lr, momentum=0.5,
                         frame_subsampling_factor=3,
                         grid_subsample=not args.no_grid)
    trainer = Trainer(model, den, config, ChainTrainingOpts(),
                      fst_pad_states=64, fst_pad_arcs=128)

    # per-step device scalars are BUFFERED and fetched in one transfer
    # at the end: a float() per step is a blocking round trip that would
    # serialize the async trainer and under-measure throughput
    outs = []
    frames = 0
    t_start = None
    steps = 0

    dl_cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs)
    pattern = os.path.join(egs_dir, "cegs.*.ark")

    if args.feats_bf16:
        import dataclasses
        import ml_dtypes

        def _cast(b):
            return dataclasses.replace(
                b, features=b.features.astype(ml_dtypes.bfloat16))
    else:
        def _cast(b):
            return b

    def batch_stream():
        while True:
            if args.loader_workers > 0:
                from kaldi_fp16_tpu.io.dataloader import ProcessLoader
                pl = ProcessLoader(pattern, dl_cfg,
                                   workers=args.loader_workers, depth=4)
                try:
                    yield from map(_cast, pl)
                finally:
                    pl.close()
            else:
                yield from map(_cast, DataLoader(pattern, dl_cfg))

    # pipelined loop, same shape as Trainer.train_epoch: batch i+1's
    # device_put is issued while step i is still in flight, so the
    # upload overlaps device compute instead of serializing ahead of
    # each dispatch.  A PrefetchLoader wrapper here can lose: the
    # producer's GIL-held numpy assembly stalls the main thread's async
    # dispatch.
    stream = batch_stream()
    nxt = next(stream)
    placed = trainer.place_batch(nxt)
    phase = {"next": 0.0, "dispatch": 0.0, "place": 0.0, "n": 0}
    while steps < args.steps:
        batch, cur = nxt, placed
        t0 = time.perf_counter()
        nxt = next(stream)
        t1 = time.perf_counter()
        out = trainer.train_batch(batch, placed=cur)
        t2 = time.perf_counter()
        placed = trainer.place_batch(nxt)
        t3 = time.perf_counter()
        if steps >= 2:
            phase["next"] += t1 - t0
            phase["dispatch"] += t2 - t1
            phase["place"] += t3 - t2
            phase["n"] += 1
        outs.append(out)
        steps += 1
        if steps == 2:
            # skip compile steps; step 2's frames are EXCLUDED along
            # with its wall time (counting them inflated throughput);
            # the sync here also fences compile/dispatch backlog out
            # of the timed window
            float(out.loss)
            t_start = time.perf_counter()
            frames = 0
        else:
            frames += batch.batch_size * batch.num_input_frames

    import jax
    jax.block_until_ready(outs[-1].loss)
    wall = time.perf_counter() - t_start if t_start else 1.0
    # contention probe: the same next(stream) with NO step in flight —
    # the delta vs the in-loop "next" phase is CPU-core/GIL contention
    # with the device client while a step executes
    t0 = time.perf_counter()
    for _ in range(4):
        next(stream)
    idle_next_ms = (time.perf_counter() - t0) / 4 * 1e3
    vals = jax.device_get([(o.loss, o.objf_per_frame, o.ok) for o in outs])
    losses = []
    for i, (loss, opf, ok) in enumerate(vals):
        losses.append(float(loss))
        print(f"step {i + 1}: loss={float(loss):.4f} "
              f"objf/frame={float(opf):.4f} ok={bool(ok)}")
    fps = frames / wall
    audio_sec_per_s = fps / 100.0
    timed_steps = max(1, steps - 2)
    step_ms = wall / timed_steps * 1e3
    improved = losses[-1] < losses[0]
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if improved else 'NOT improved'})")
    print(f"throughput: {fps:,.0f} frames/s = {audio_sec_per_s:,.1f} "
          f"audio-sec/s/chip ({step_ms:.1f} ms/step over {timed_steps} "
          f"timed steps, incl. host dataloader)")
    if phase["n"]:
        n = phase["n"]
        print(f"host-phase attribution (ms/step, blocking time on the "
              f"dispatch thread): next={phase['next'] / n * 1e3:.1f} "
              f"dispatch={phase['dispatch'] / n * 1e3:.1f} "
              f"place={phase['place'] / n * 1e3:.1f} "
              f"idle-next={idle_next_ms:.1f} "
              f"(in-loop minus idle next = contention with the device "
              f"client)")

    if args.bench_json:
        print(json.dumps({
            "metric": "train_audio_sec_per_s_per_chip",
            "value": round(audio_sec_per_s, 1),
            "unit": "audio-sec/s",
            "vs_baseline": None,
        }))
    sys.exit(0 if improved else 1)


if __name__ == "__main__":
    main()
