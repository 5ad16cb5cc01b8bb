#!/usr/bin/env python
"""train — the full training driver (ref: scripts/train_cnn_tdnn.sh:
epochs 15, lr 1e-3 -> 1e-4 exponential, batch 64, warmup).

Trains an xconfig acoustic model on cegs ark files with the chain objective,
checkpointing, JSONL metrics, LR scheduling, and optional multi-device data
parallelism.

Usage:
  python tools/train.py --egs 'data/cegs.*.ark' --den-fst data/den.fst \\
      --xconfig configs/cnn_tdnn.xconfig --pdfs 3080 \\
      --epochs 15 --batch 64 --lr 1e-3 --lr-final 1e-4 \\
      --ckpt-dir exp/ckpt --metrics exp/metrics.jsonl
"""

import argparse
import os
import sys

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--egs", required=True)
    ap.add_argument("--den-fst", required=True)
    ap.add_argument("--xconfig", required=True)
    ap.add_argument("--pdfs", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-final", type=float, default=1e-4)
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--max-param-change", type=float, default=2.0)
    ap.add_argument("--l2-regularize", type=float, default=0.0)
    ap.add_argument("--xent-regularize", type=float, default=0.0)
    ap.add_argument("--loss-scaling", action="store_true",
                    help="dynamic loss scaling (65536 init, 2x/2000 growth, "
                         "0.5 backoff); needed for fp16, optional for bf16")
    ap.add_argument("--orthonormal-interval", type=int, default=4,
                    help="apply the TDNN-F semi-orthogonal constraint "
                         "every N steps (0 disables)")
    ap.add_argument("--natural-gradient", action="store_true",
                    help="Kaldi NG-SGD: precondition affine grads with "
                         "online low-rank Fisher estimates")
    ap.add_argument("--leaky-hmm", type=float, default=1e-5)
    ap.add_argument("--den-mode", default="exact", choices=["exact", "fast"],
                    help="denominator numerics: exact (bf16x3 parity "
                         "class, the production default) or fast "
                         "(single-pass bf16 — EXPERIMENTAL: the r3 "
                         "flagship-scale A/B measured trajectory "
                         "divergence of 0.08-0.13 objf/frame over 224 "
                         "steps)")
    ap.add_argument("--bn-lowp", action="store_true",
                    help="batchnorm in bf16 with fp32-accumulated stats "
                         "(no fp32 activation upcast) — REVOKED for "
                         "production: +16%% step throughput at flagship "
                         "B=128 (81 vs 94 ms) but the r3 flagship A/B "
                         "measured 2.31 max objf/frame trajectory "
                         "divergence over 112 steps; measurement hook "
                         "only)")
    ap.add_argument("--no-grid", action="store_true",
                    help="disable frame-grid subsampling: run the "
                         "grid-eligible (post-CNN) stack at the full "
                         "input frame rate instead of only at "
                         "chain-supervision frames (the nnet3-compiler "
                         "behavior; see models/network.py grid_layers)")
    ap.add_argument("--feats-bf16", action="store_true",
                    help="cast features to bfloat16 on host before "
                         "upload: halves the dominant H2D buffer and the "
                         "transfer-serialization CPU.  The network "
                         "consumes inputs in "
                         "bf16 anyway; the only numerics delta is input "
                         "rounding before instead of at the first matmul "
                         "(convergence A/B: abtest.py --ab feats-bf16)")
    ap.add_argument("--frame-subsampling", type=int, default=3)
    ap.add_argument("--shuffle-buffer", type=int, default=1024)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="background prefetch depth (0 = synchronous)")
    ap.add_argument("--loader-workers", type=int, default=0,
                    help="ingestion workers: N>0 = N OS processes "
                         "(ProcessLoader — scales parse AND assembly on "
                         "multi-core hosts), 0 = single pipeline with "
                         "--prefetch overlap")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="checkpoints retained (size >= --average-last)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--valid-egs",
                    help="held-out cegs glob: per-epoch valid objf/frame "
                         "diagnostics (compute_prob analog — eval-mode "
                         "forward, no updates; Kaldi baseline for a "
                         "trained model: ~-0.17/frame, BASELINE.md)")
    ap.add_argument("--average-last", type=int, default=0,
                    help="after training, average the params of the last "
                         "N checkpoints (Kaldi final-model combination's "
                         "equal-weight analog) and save as the final "
                         "model; reports valid objf for both when "
                         "--valid-egs is given")
    ap.add_argument("--metrics")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="cap steps per epoch (0 = full pass)")
    ap.add_argument("--fst-pad-states", type=int, default=256)
    ap.add_argument("--fst-pad-arcs", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (numerics work; perf "
                         "numbers meaningless)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="shard training over N devices (data axis; "
                         "0 = single device, -1 = all local devices). "
                         "Batch must divide by N.  Tensor-parallel wide "
                         "heads engage automatically when the mesh has "
                         "a model axis (see parallel/mesh.py)")
    args = ap.parse_args()

    if args.cpu:
        _common.force_cpu()
    import jax
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu.io.dataloader import (
        DataLoader, DataLoaderConfig, PrefetchLoader,
    )
    from kaldi_fp16_tpu.io.fst import read_fst_file
    from kaldi_fp16_tpu.models.model import build_model
    from kaldi_fp16_tpu.training.checkpoint import CheckpointManager, DataPosition
    from kaldi_fp16_tpu.training.schedulers import warmup_lr
    from kaldi_fp16_tpu.training.train_step import TrainConfig
    from kaldi_fp16_tpu.training.trainer import Trainer, exponential_lr
    from kaldi_fp16_tpu.utils.metrics import MetricsLogger
    from kaldi_fp16_tpu.utils.profiling import StepTimer

    if args.bn_lowp:
        from kaldi_fp16_tpu.models.network import set_bn_lowp_stats
        set_bn_lowp_stats(True)  # must precede tracing (read at trace time)
    model = build_model(args.xconfig)
    print(model.summary())

    den_fst = read_fst_file(args.den_fst)
    print(f"den.fst: {den_fst.num_states} states, {den_fst.num_arcs} arcs")
    den_graph = DenominatorGraph.from_fst(den_fst, args.pdfs)
    den = DenominatorComputation(den_graph, leaky=args.leaky_hmm,
                                 mode=args.den_mode)

    # estimate total steps for the lr schedule from a cheap marker scan
    # (a full decoding pass over a production dataset would double
    # time-to-first-step); bucketing/invalid examples make this an upper
    # bound, which only flattens the LR tail slightly
    import glob as globlib
    from kaldi_fp16_tpu.io.egs import count_examples
    n_examples = sum(count_examples(f) for f in sorted(globlib.glob(args.egs)))
    n_batches = n_examples // args.batch
    if n_batches == 0:
        sys.exit(f"error: no full batches — fewer than --batch {args.batch} "
                 f"examples in {args.egs!r} ({n_examples} found); lower --batch")
    if args.steps_per_epoch:
        n_batches = min(n_batches, args.steps_per_epoch)
    total_steps = max(n_batches * args.epochs, 1)
    print(f"{n_batches} batches/epoch, {total_steps} total steps")

    schedule = exponential_lr(args.lr, args.lr_final, total_steps)
    if args.warmup_steps:
        schedule = warmup_lr(schedule, args.warmup_steps)

    config = TrainConfig(learning_rate=args.lr, momentum=args.momentum,
                         max_param_change=args.max_param_change,
                         frame_subsampling_factor=args.frame_subsampling,
                         xent_regularize=args.xent_regularize,
                         natural_gradient=args.natural_gradient,
                         orthonormal_interval=args.orthonormal_interval,
                         use_loss_scaling=args.loss_scaling,
                         grid_subsample=not args.no_grid)
    chain_opts = ChainTrainingOpts(l2_regularize=args.l2_regularize,
                                   leaky_hmm_coefficient=args.leaky_hmm,
                                   xent_regularize=args.xent_regularize)
    mesh = None
    if args.data_parallel:
        from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh
        n = (len(jax.devices()) if args.data_parallel < 0
             else args.data_parallel)
        mesh = make_mesh(MeshConfig(data=n))
        if args.batch % n:
            raise SystemExit(f"--batch {args.batch} must divide by "
                             f"--data-parallel {n}")
        print(f"data-parallel over {n} devices: {dict(mesh.shape)}")
    trainer = Trainer(model, den, config, chain_opts, lr_schedule=schedule,
                      seed=args.seed, fst_pad_states=args.fst_pad_states,
                      fst_pad_arcs=args.fst_pad_arcs, mesh=mesh)

    mgr = (CheckpointManager(args.ckpt_dir,
                             max_to_keep=max(args.ckpt_keep,
                                             args.average_last))
           if args.ckpt_dir else None)
    if args.average_last > 1 and not mgr:
        sys.exit("error: --average-last needs --ckpt-dir")

    def run_valid(tag="valid"):
        """One eval pass over --valid-egs; logs+returns objf/frame."""
        if not args.valid_egs:
            return None
        v_cfg = DataLoaderConfig(batch_size=args.batch,
                                 label_dim=args.pdfs,
                                 shuffle_files=False,
                                 max_fst_states=args.fst_pad_states,
                                 max_fst_arcs=args.fst_pad_arcs)
        res = trainer.eval_epoch(DataLoader(args.valid_egs, v_cfg))
        if res is None:
            print(f"warning: no full batches in --valid-egs "
                  f"{args.valid_egs!r} at --batch {args.batch}")
            return None
        print(f"{tag} objf/frame={res['objf_per_frame']:.4f} "
              f"num={res['num_logprob']:.4f} den={res['den_logprob']:.4f} "
              f"({res['batches']} batches, {res['frames']:.0f} frames)")
        if metrics:
            metrics.log(trainer.global_step,
                        **{f"{tag}_objf_per_frame": res["objf_per_frame"],
                           f"{tag}_num": res["num_logprob"],
                           f"{tag}_den": res["den_logprob"]})
        return res["objf_per_frame"]
    start_epoch = 0
    skip_batches = 0   # fast-forward count for the first resumed epoch
    if args.resume and mgr and mgr.latest_step() is not None:
        pos = trainer.restore(mgr)   # restores AND re-places on the mesh
        start_epoch = pos.epoch
        # replay fidelity: the epoch's batch order is deterministic
        # (loader seeded with seed+epoch), so skipping the consumed
        # batches resumes on EXACTLY the next batch the killed run
        # would have trained on; without this, a mid-epoch resume
        # re-trained the epoch's first batches under a mid-epoch
        # global_step (caught by tools/soak.py's replay check, r3)
        skip_batches = pos.batches_consumed
        print(f"resumed from step {trainer.global_step} "
              f"(epoch {pos.epoch}, skipping {skip_batches} "
              f"consumed batches)")

    metrics = MetricsLogger(args.metrics, echo=False) if args.metrics else None
    timer = StepTimer(skip_first=2)

    for epoch in range(start_epoch, args.epochs):
        dl_cfg = DataLoaderConfig(batch_size=args.batch,
                                  label_dim=args.pdfs,
                                  shuffle_files=True,
                                  shuffle_buffer=args.shuffle_buffer,
                                  seed=args.seed + epoch,
                                  max_fst_states=args.fst_pad_states,
                                  max_fst_arcs=args.fst_pad_arcs)
        if args.loader_workers > 0:
            from kaldi_fp16_tpu.io.dataloader import ProcessLoader
            batches = ProcessLoader(args.egs, dl_cfg,
                                    workers=args.loader_workers,
                                    depth=max(1, args.prefetch))
        elif args.prefetch:
            batches = PrefetchLoader(DataLoader(args.egs, dl_cfg),
                                     args.prefetch)
        else:
            batches = DataLoader(args.egs, dl_cfg)
        if args.feats_bf16:
            import dataclasses as _dc
            import ml_dtypes

            class _Bf16Feeds:
                def __init__(self, inner):
                    self._inner = inner

                def __iter__(self):
                    for b in self._inner:
                        yield _dc.replace(
                            b, features=b.features.astype(
                                ml_dtypes.bfloat16))

                def close(self, *a, **k):
                    if hasattr(self._inner, "close"):
                        self._inner.close(*a, **k)

            batches = _Bf16Feeds(batches)
        epoch_objf = []
        # per-step scalars stay ON DEVICE and are fetched in one
        # device_get per log window: a float() per step is a blocking
        # round trip that would stall the host every step
        pending = []   # (global_step, TrainStepOutput, lr)

        def flush():
            if not pending:
                return None
            vals = jax.device_get(
                [(o.loss, o.objf_per_frame, o.num_logprob, o.den_logprob,
                  o.grad_norm) for _, o, _ in pending])
            last = None
            for (gstep, _, lr), (loss, opf, num, den, gn) in zip(
                    pending, vals):
                last = float(opf)
                epoch_objf.append(last)
                if metrics:
                    metrics.log(gstep, epoch=epoch, loss=float(loss),
                                objf_per_frame=last, num=float(num),
                                den=float(den), grad_norm=float(gn), lr=lr)
            pending.clear()
            return last

        try:
            # pipelined loop: upload batch i+1 (async device_put) while
            # step i executes on device
            it = iter(batches)
            i = 0
            if epoch == start_epoch and skip_batches:
                for i in range(skip_batches):
                    if next(it, None) is None:
                        break
                i = skip_batches
            nxt = next(it, None)
            placed = trainer.place_batch(nxt) if nxt is not None else None
            while nxt is not None:
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                batch, cur = nxt, placed
                nxt = next(it, None)
                with timer:
                    out = trainer.train_batch(batch, placed=cur)
                placed = (trainer.place_batch(nxt)
                          if nxt is not None else None)
                pending.append((trainer.global_step, out,
                                schedule(trainer.global_step)))
                if (i + 1) % args.log_every == 0:
                    last = flush()
                    print(f"epoch {epoch} step {trainer.global_step}: "
                          f"objf/frame={last:.4f} "
                          f"lr={schedule(trainer.global_step):.2e}")
                if mgr and trainer.global_step % args.ckpt_every == 0:
                    flush()   # checkpoint saves sync anyway
                    mgr.save(trainer.global_step, trainer.params,
                             trainer.net_state, trainer.opt_state,
                             trainer.scale_state,
                             DataPosition(epoch=epoch, batches_consumed=i + 1,
                                          rng_key=trainer.rng_key))
                i += 1
            flush()
        finally:
            if args.loader_workers > 0 or args.prefetch:
                batches.close()  # stop producers on early break
        print(f"epoch {epoch}: avg objf/frame = {np.mean(epoch_objf):.4f}  "
              f"{timer.summary()}")
        run_valid()

    if mgr:
        mgr.save(trainer.global_step, trainer.params, trainer.net_state,
                 trainer.opt_state, trainer.scale_state,
                 DataPosition(epoch=args.epochs, rng_key=trainer.rng_key))

    if args.average_last > 1 and mgr:
        # Kaldi-style final-model combination, equal-weight analog:
        # average the PARAMS of the last N retained checkpoints (BN
        # stats / optimizer state stay the final model's — averaging
        # momentum or Fisher factors has no Kaldi meaning)
        steps = mgr.all_steps()[-args.average_last:]
        if len(steps) < 2:
            print(f"--average-last {args.average_last}: only "
                  f"{len(steps)} checkpoints retained, skipping")
        else:
            final_valid = run_valid("final")
            acc = None
            for s in steps:
                p_s = mgr.restore(s, trainer.params, trainer.net_state,
                                  trainer.opt_state, trainer.scale_state)[0]
                acc = (p_s if acc is None else jax.tree_util.tree_map(
                    lambda a, b: a + b, acc, p_s))
            trainer.params = jax.tree_util.tree_map(
                lambda a: (a / len(steps)).astype(a.dtype), acc)
            trainer.place_states()
            print(f"averaged params over checkpoints {steps}")
            avg_valid = run_valid("averaged")
            if (final_valid is not None and avg_valid is not None
                    and avg_valid < final_valid):
                print("note: averaged model scored below the final model "
                      "on valid — keeping the averaged save anyway "
                      "(pick by the metrics log)")
            mgr.save(trainer.global_step + 1, trainer.params,
                     trainer.net_state, trainer.opt_state,
                     trainer.scale_state,
                     DataPosition(epoch=args.epochs,
                                  rng_key=trainer.rng_key))
            print(f"averaged model saved as step {trainer.global_step + 1}")

    if mgr:
        mgr.close()
    if metrics:
        metrics.close()
    print(f"done: {trainer.global_step} steps, "
          f"final objf/frame {trainer.metrics.objf_per_frame:.4f}")


if __name__ == "__main__":
    main()
