#!/usr/bin/env python
"""chainbench — benchmark the chain numerator/denominator kernels at the
reference's production scale (ref: cmd/chainbench; BASELINE.md: chain loss
for a batch of 8 sequences = ~91 ms on the RTX 4090).

Runs on whatever backend JAX selects.

Usage: python tools/chainbench.py [--batch 8] [--frames 50] [--pdfs 3080]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import _common  # noqa: F401


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=50)  # post-subsampling
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--den-states", type=int, default=7052)
    ap.add_argument("--den-arcs", type=int, default=113380)
    ap.add_argument("--num-states", type=int, default=200)
    ap.add_argument("--num-arcs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--topology", default="random",
                    choices=["random", "phone-lm"],
                    help="random = locality-free worst case; phone-lm = "
                         "realistic den.fst structure")
    ap.add_argument("--matmul-impl", default="dot",
                    choices=["dot", "split3"],
                    help="structured-den exact-mode dense matmul lowering "
                         "(split3 = single-read stacked bf16 3-term split; "
                         "dot = one XLA dot at the exact-mode precision)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "structured", "blocked"],
                    help="denominator kernel layout: auto routes phone-lm "
                         "to the chain-decomposed kernels; blocked forces "
                         "the generic gather path for comparison")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, NumeratorGraphBatch, LOG_ZERO,
    )
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.numerator import numerator_forward_backward

    rng = np.random.default_rng(0)
    B, T, P = args.batch, args.frames, args.pdfs
    S, A = args.den_states, args.den_arcs

    if args.topology == "phone-lm":
        # realistic den.fst topology: phone-LM over L-R HMMs with
        # self-loops -> gather locality like the real production graph
        from kaldi_fp16_tpu.chain.graph import make_phone_lm_den_fst
        # production shape by default; scale down with --pdfs for smokes
        kw = {} if P >= 3080 else dict(
            num_phones=max(2, P // 2), states_per_phone=2,
            branching=min(8, max(2, P // 4)))
        fst = make_phone_lm_den_fst(num_pdfs=P, **kw)
        graph = DenominatorGraph.from_fst(fst, P)
        S, A = graph.num_states, graph.num_transitions
    else:
        # uniformly random graph at den.fst scale: the locality-free
        # WORST case for the blocked gathers
        dst = np.sort(rng.integers(0, S, size=A).astype(np.int32))
        graph = DenominatorGraph(
            src=rng.integers(0, S, size=A).astype(np.int32),
            dst=dst,
            pdf=rng.integers(0, P, size=A).astype(np.int32),
            prob=rng.uniform(0.1, 1.0, size=A).astype(np.float32),
            initial=(lambda v: v / v.sum())(
                rng.uniform(0, 1, S).astype(np.float32)),
            num_states=S, num_pdfs=P, start_state=0)
    den = DenominatorComputation(graph, leaky=1e-5, layout=args.layout,
                                 matmul_impl=args.matmul_impl)

    # synthetic numerator batch: a linear chain of EXACTLY T arcs (each
    # chain arc consumes one frame, so any other length leaves the only
    # final state unreachable and benches the -inf/containment path),
    # plus parallel alternative arcs up to An.
    Sn, An = T + 1, max(args.num_arcs, T)
    num_graph = NumeratorGraphBatch(
        arc_src=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1), (B, 1)),
        arc_dst=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1) + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)

    out = jnp.asarray(rng.normal(size=(B, T, P)).astype(np.float32) * 0.1)

    @jax.jit
    def den_fb(x):
        return den.forward_backward(x)

    @jax.jit
    def num_fb(x):
        return numerator_forward_backward(num_graph, x)

    results = {}
    for name, fn in [("den_fwd_bwd", den_fb), ("num_fwd_bwd", num_fb)]:
        r = fn(out)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = fn(out)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        ms = (time.perf_counter() - t0) / args.iters * 1000
        results[name] = round(ms, 2)

    total = results["den_fwd_bwd"] + results["num_fwd_bwd"]
    per_seq = total / B
    # reference: ~91 ms for an 8-sequence batch = 11.375 ms/sequence
    print(json.dumps({
        "metric": "chain_loss_ms_per_sequence",
        "value": round(per_seq, 3),
        "unit": "ms/seq",
        "vs_baseline": round(11.375 / per_seq, 3),  # >1 = faster than reference
        "detail": {**results, "batch_total_ms": round(total, 2),
                   "den_layout": den.layout_used},
        "config": {"B": B, "T": T, "P": P, "den_states": S, "den_arcs": A},
    }))


if __name__ == "__main__":
    main()
