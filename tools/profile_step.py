"""profile_step — attribute the flagship train step by IN-CONTEXT ablation.

Isolated sub-measurements (fwd 12.8 ms + bwd 25 ms + den 26.8 ms + num
4 ms) never sum to the measured full step, because XLA fuses across
different boundaries in the full program (r3 finding).  This tool
attributes the step honestly: every variant is the SAME make_train_step
program at identical geometry with exactly one stage replaced by a
zero-cost stand-in, so `full - variant` is that stage's true in-context
cost, fusion included.

Variants:
  full       the production step (exact structured den, momentum,
             max-change, orthonormal)
  no-den     denominator forward-backward replaced by zeros (numerator,
             OOR penalty, combine, network, optimizer all unchanged)
  no-num     numerator forward-backward replaced by zeros
  no-chain   whole chain objective replaced by a trivial differentiable
             sum (network fwd+bwd + optimizer + dispatch only)
  fwd-only   jit(forward + frame subsample + sum) — no grad, no update

--lean ablates the optimizer extras (momentum + max-change +
orthonormal).

Run from the repo root:  python tools/profile_step.py [--iters N]
"""
import _common
import argparse
import time

import numpy as np

_common.enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kaldi_fp16_tpu.training.train_step as ts_mod  # noqa: E402
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation  # noqa: E402
from kaldi_fp16_tpu.chain.graph import (  # noqa: E402
    DenominatorGraph, NumeratorGraphBatch, LOG_ZERO, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu.chain.objective import (  # noqa: E402
    ChainResult, ChainTrainingOpts, make_chain_objf_with_post,
)
import kaldi_fp16_tpu.chain.objective as objective_mod  # noqa: E402
from kaldi_fp16_tpu.models.model import build_model  # noqa: E402
from kaldi_fp16_tpu.models.network import forward, subsample_output  # noqa: E402
from kaldi_fp16_tpu.training.train_step import (  # noqa: E402
    TrainConfig, init_train_state, make_train_step,
)


class _ZeroDen:
    """Stand-in denominator: zero logprob, zero posteriors.  Keeps the
    chain combine/containment graph intact while deleting the den
    scans + posterior pass from the program."""

    def forward_backward(self, nnet_output):
        B = nnet_output.shape[0]
        return (jnp.zeros(B, jnp.float32),
                jnp.zeros_like(nnet_output))


def _zero_num(num_graph, nnet_output):
    B = nnet_output.shape[0]
    return (jnp.zeros(B, jnp.float32), jnp.zeros_like(nnet_output))


def _trivial_objf_factory(num_graph, den, opts):
    """Differentiable stand-in for the whole chain objective: the
    gradient (ones) still drives the full network backward."""

    def objf_fn(nnet_output, weights, deriv_weights):
        B, T, P = nnet_output.shape
        objf = jnp.sum(nnet_output) * jnp.float32(1e-6)
        result = ChainResult(
            total_objf=objf,
            l2_term=jnp.zeros((), jnp.float32),
            total_weight=jnp.sum(weights) * T,
            num_logprob=jnp.zeros(B, jnp.float32),
            den_logprob=jnp.zeros(B, jnp.float32),
            objf_per_frame=objf / (B * T),
            out_of_range_count=jnp.zeros((), jnp.int32),
            ok=jnp.ones(B, bool),
        )
        return objf, result, jax.lax.stop_gradient(
            jnp.zeros_like(nnet_output))

    return objf_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=150)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--xconfig", default="configs/cnn_tdnn.xconfig")
    ap.add_argument("--lean", action="store_true",
                    help="also measure the r3 optimizer-extras ablation")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        _common.force_cpu()

    rng = np.random.default_rng(0)
    B, T_in, P = args.batch, args.frames_in, args.pdfs
    left, stride = 3, 3
    T_out = (T_in - left + stride - 1) // stride

    model = build_model(args.xconfig)
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=P), P)
    den = DenominatorComputation(graph, leaky=1e-5, mode="exact")

    An, Sn = max(256, T_out), T_out + 1
    num_graph = NumeratorGraphBatch(
        arc_src=np.tile(np.arange(An, dtype=np.int32) % T_out, (B, 1)),
        arc_dst=np.tile(np.arange(An, dtype=np.int32) % T_out + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)

    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=stride, left_context=left)

    batch = {
        "features": jnp.asarray(rng.normal(size=(B, T_in, 40))
                                .astype(np.float32)),
        "ivectors": jnp.asarray(rng.normal(size=(B, 100))
                                .astype(np.float32)),
        "weights": jnp.ones(B, jnp.float32),
    }
    key = jax.random.PRNGKey(1)
    ITERS = args.iters

    def bench_step(step, cfg):
        p, ns, os_, ss = init_train_state(model, jax.random.PRNGKey(0), cfg)
        k, sub = jax.random.split(key)
        p, ns, os_, ss, out = step(p, ns, os_, ss, batch, sub)
        jax.block_until_ready(out.loss)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            k, sub = jax.random.split(k)
            p, ns, os_, ss, out = step(p, ns, os_, ss, batch, sub)
        jax.block_until_ready(out.loss)
        return (time.perf_counter() - t0) / ITERS * 1e3

    results = {}

    step = make_train_step(model, den, num_graph, ChainTrainingOpts(),
                           config, num_frames_out=T_out, donate=True)
    results["full"] = bench_step(step, config)
    print(f"full step          : {results['full']:7.2f} ms")

    step_noden = make_train_step(model, _ZeroDen(), num_graph,
                                 ChainTrainingOpts(), config,
                                 num_frames_out=T_out, donate=True)
    results["no-den"] = bench_step(step_noden, config)
    print(f"no-den             : {results['no-den']:7.2f} ms "
          f"(den in-context = {results['full'] - results['no-den']:.2f})")

    saved_num = objective_mod.numerator_forward_backward
    objective_mod.numerator_forward_backward = _zero_num
    try:
        step_nonum = make_train_step(model, den, num_graph,
                                     ChainTrainingOpts(), config,
                                     num_frames_out=T_out, donate=True)
        results["no-num"] = bench_step(step_nonum, config)
    finally:
        objective_mod.numerator_forward_backward = saved_num
    print(f"no-num             : {results['no-num']:7.2f} ms "
          f"(num in-context = {results['full'] - results['no-num']:.2f})")

    saved_make = ts_mod.make_chain_objf_with_post
    ts_mod.make_chain_objf_with_post = _trivial_objf_factory
    try:
        step_nochain = make_train_step(model, den, num_graph,
                                       ChainTrainingOpts(), config,
                                       num_frames_out=T_out, donate=True)
        results["no-chain"] = bench_step(step_nochain, config)
    finally:
        ts_mod.make_chain_objf_with_post = saved_make
    print(f"no-chain           : {results['no-chain']:7.2f} ms "
          f"(chain in-context = "
          f"{results['full'] - results['no-chain']:.2f})")

    # forward only, same geometry (no grad, no update)
    params, net_state, _, _ = init_train_state(
        model, jax.random.PRNGKey(0), config)
    chain_head = model.chain_output().name

    @jax.jit
    def fwd_only(p, ns, feats, ivecs, rng):
        outs, _ = forward(model, p, ns, feats, ivecs, train=True, rng=rng,
                          compute_dtype=jnp.bfloat16)
        out = subsample_output(outs[chain_head].astype(jnp.float32),
                               stride, left, T_out)
        return jnp.sum(out)

    k, sub = jax.random.split(key)
    r = fwd_only(params, net_state, batch["features"], batch["ivectors"],
                 sub)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        k, sub = jax.random.split(k)
        r = fwd_only(params, net_state, batch["features"],
                     batch["ivectors"], sub)
    jax.block_until_ready(r)
    results["fwd-only"] = (time.perf_counter() - t0) / ITERS * 1e3
    print(f"fwd-only           : {results['fwd-only']:7.2f} ms")

    if args.lean:
        cfg2 = TrainConfig(learning_rate=1e-3, momentum=0.0,
                           frame_subsampling_factor=stride,
                           left_context=left, orthonormal_interval=0,
                           max_param_change=0.0)
        step2 = make_train_step(model, den, num_graph, ChainTrainingOpts(),
                                cfg2, num_frames_out=T_out, donate=True)
        results["lean"] = bench_step(step2, cfg2)
        print(f"lean (no opt extras): {results['lean']:7.2f} ms "
              f"(optimizer extras = "
              f"{results['full'] - results['lean']:.2f})")

    full = results["full"]
    print("\nattribution (in-context):")
    print(f"  den fwd-bwd      : {full - results['no-den']:7.2f} ms")
    print(f"  num fwd-bwd      : {full - results['no-num']:7.2f} ms")
    print(f"  chain total      : {full - results['no-chain']:7.2f} ms")
    print(f"  network fwd+bwd+opt (no-chain): {results['no-chain']:7.2f} ms")
    print(f"  network fwd (fwd-only)        : {results['fwd-only']:7.2f} ms")


if __name__ == "__main__":
    main()
