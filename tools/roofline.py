#!/usr/bin/env python
"""roofline — speed-of-light analysis of the training pipeline's stages.

SURVEY.md §5 calls for per-kernel roofline reporting as a first-class
subsystem (the reference's whole story is "profile, find the gap, fix
it" with external Nsight).  For each stage this measures wall time on
the attached chip, pulls FLOPs/bytes from XLA's compiled cost analysis,
and reports achieved TFLOP/s and GB/s against the chip's peaks with the
implied bound (compute vs memory).

Stages: flagship forward, forward+grad, denominator fwd-bwd (production
den.fst scale), numerator fwd-bwd, one full train step.

Peaks come from utils.profiling.DEVICE_PEAKS (bf16 tensor-core rate and
HBM bandwidth) for the device JAX reports; an unknown device is an error.

Usage: python tools/roofline.py [--batch 128] [--frames 150]
       [--stages fwd,bwd,den,num,step]
"""

import argparse
import json
import time

import _common  # noqa: F401
import numpy as np


def measure(fn, args, iters=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def cost(fn, args):
    import jax
    try:
        c = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(c, list):
            c = c[0] if c else {}
        return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))
    except Exception:
        return 0.0, 0.0


def report(name, seconds, flops, bytes_, peak_tflops, peak_gbs):
    tflops = flops / seconds / 1e12 if seconds else 0.0
    gbs = bytes_ / seconds / 1e9 if seconds else 0.0
    pct_c = 100.0 * tflops / peak_tflops
    pct_m = 100.0 * gbs / peak_gbs
    bound = "compute" if pct_c >= pct_m else "memory"
    return {
        "stage": name, "ms": round(seconds * 1e3, 2),
        "gflop": round(flops / 1e9, 1),
        "tflops": round(tflops, 1), "pct_peak_compute": round(pct_c, 1),
        "gbs": round(gbs, 1), "pct_peak_bw": round(pct_m, 1),
        "bound": bound,
    }


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--stages", default="fwd,bwd,den,num,step")
    ap.add_argument("--topology", choices=["phone-lm", "random"],
                    default="phone-lm",
                    help="phone-lm (default) = the production den.fst "
                         "class, which decomposes into the STRUCTURED "
                         "den layout (the promoted path); random = "
                         "locality-free graph that falls back to the "
                         "generic blocked path")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    stages = set(args.stages.split(","))

    import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.models.model import build_model
    from kaldi_fp16_tpu.models.network import forward, init_params
    from kaldi_fp16_tpu.utils.profiling import device_peaks

    peaks = device_peaks(jax.devices()[0].device_kind)
    peak_tflops, peak_gbs = peaks["bf16_tflops"], peaks["hbm_gbs"]
    rng = np.random.default_rng(0)
    B, T, P = args.batch, args.frames, args.pdfs
    model = build_model("configs/cnn_tdnn.xconfig")
    params, state = init_params(model, jax.random.PRNGKey(0))
    feats = jnp.asarray(rng.normal(size=(B, T, 40)).astype(np.float32))
    ivecs = jnp.asarray(rng.normal(size=(B, 100)).astype(np.float32))
    rows = []

    def fwd_loss(params, feats, ivecs):
        outs, _ = forward(model, params, state, feats, ivecs,
                          train=False, compute_dtype=jnp.bfloat16)
        return outs["output"].astype(jnp.float32).sum()

    if "fwd" in stages:
        f = jax.jit(fwd_loss)
        sec = measure(f, (params, feats, ivecs), args.iters)
        fl, by = cost(fwd_loss, (params, feats, ivecs))
        rows.append(report("forward", sec, fl, by,
                           peak_tflops, peak_gbs))

    if "bwd" in stages:
        g = jax.jit(lambda p, f, i: jax.grad(fwd_loss)(p, f, i))
        sec = measure(g, (params, feats, ivecs), args.iters)
        fl, by = cost(lambda p, f, i: jax.grad(fwd_loss)(p, f, i),
                      (params, feats, ivecs))
        rows.append(report("forward+grad", sec, fl, by,
                           peak_tflops, peak_gbs))

    if "den" in stages or "num" in stages or "step" in stages:
        from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
        from kaldi_fp16_tpu.chain.graph import (
            DenominatorGraph, NumeratorGraphBatch, LOG_ZERO,
        )
        S, A, An = 7052, 113380, 256
        T_out = 49
        if args.topology == "phone-lm":
            from kaldi_fp16_tpu.chain.graph import make_phone_lm_den_fst
            kw = {} if P >= 3080 else dict(
                num_phones=max(2, P // 2), states_per_phone=2,
                branching=min(8, max(2, P // 4)))
            graph = DenominatorGraph.from_fst(
                make_phone_lm_den_fst(num_pdfs=P, **kw), P)
        else:
            dst = np.sort(rng.integers(0, S, size=A).astype(np.int32))
            graph = DenominatorGraph(
                src=rng.integers(0, S, size=A).astype(np.int32), dst=dst,
                pdf=rng.integers(0, P, size=A).astype(np.int32),
                prob=rng.uniform(0.1, 1.0, size=A).astype(np.float32),
                initial=(lambda v: v / v.sum())(
                    rng.uniform(0, 1, S).astype(np.float32)),
                num_states=S, num_pdfs=P, start_state=0)
        den = DenominatorComputation(graph, leaky=1e-5)
        x_out = jnp.asarray(
            rng.normal(size=(B, T_out, P)).astype(np.float32) * 0.1)

        if "den" in stages:
            sec = measure(lambda x: den.forward_backward(x), (x_out,),
                          args.iters)
            fl, by = cost(
                lambda x: den._forward_backward(x, compute_grad=True),
                (x_out,))
            rows.append(report("den fwd-bwd", sec, fl, by,
                               peak_tflops, peak_gbs))

        if "num" in stages:
            from kaldi_fp16_tpu.chain.numerator import (
                numerator_forward_backward,
            )
            Sn = An // 2 + 2
            num = NumeratorGraphBatch(
                arc_src=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1),
                                (B, 1)),
                arc_dst=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1) + 1,
                                (B, 1)),
                arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
                arc_logw=np.zeros((B, An), np.float32),
                arc_mask=np.ones((B, An), np.float32),
                start=np.zeros(B, np.int32),
                final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                                    LOG_ZERO).astype(np.float32).repeat(B, 0),
                num_states=Sn, num_arcs=An)
            fn = lambda x: numerator_forward_backward(num, x)  # noqa: E731
            sec = measure(jax.jit(fn), (x_out,), args.iters)
            fl, by = cost(fn, (x_out,))
            rows.append(report("num fwd-bwd", sec, fl, by,
                               peak_tflops, peak_gbs))

        if "step" in stages:
            from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
            from kaldi_fp16_tpu.training.train_step import (
                TrainConfig, init_train_state, make_train_step,
            )
            Sn = An // 2 + 2
            num = NumeratorGraphBatch(
                arc_src=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1),
                                (B, 1)),
                arc_dst=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1) + 1,
                                (B, 1)),
                arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
                arc_logw=np.zeros((B, An), np.float32),
                arc_mask=np.ones((B, An), np.float32),
                start=np.zeros(B, np.int32),
                final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                                    LOG_ZERO).astype(np.float32).repeat(B, 0),
                num_states=Sn, num_arcs=An)
            config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                                 frame_subsampling_factor=3, left_context=3)
            step = make_train_step(model, den, num, ChainTrainingOpts(),
                                   config, num_frames_out=T_out, donate=False)
            p2, ns, os_, ss = init_train_state(model, jax.random.PRNGKey(0),
                                               config)
            batch = {"features": feats, "ivectors": ivecs,
                     "weights": jnp.ones(B, jnp.float32)}
            key = jax.random.PRNGKey(1)

            def run(p2, ns, os_, ss):
                return step(p2, ns, os_, ss, batch, key)

            out = run(p2, ns, os_, ss)
            jax.block_until_ready(out[4].loss)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = run(*out[:4])
            jax.block_until_ready(out[4].loss)
            sec = (time.perf_counter() - t0) / args.iters
            rows.append(report("train step", sec, 0.0, 0.0,
                               peak_tflops, peak_gbs))

    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
