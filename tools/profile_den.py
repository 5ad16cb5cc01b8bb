#!/usr/bin/env python
"""Attribute structured-denominator time: scan matmuls vs posteriors.

Three measurements at production scale (7052 states / 3080 pdfs phone-LM,
F=3526 chains, L=2), per exact-mode matmul lowering (dot | split3):

  1. matmul-in-scan microbench: T*2 sequential [F,F]@[F,N] applications —
     the isolated cost of the M traffic the den scans pay (fwd T steps +
     beta T steps).
  2. den forward() only (fwd scan, no posterior machinery).
  3. den forward_backward() (adds beta scan + bulk posterior pass).

Usage: python tools/profile_den.py [--batch 128] [--frames 49] [--iters 10]
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")
from tools._common import enable_compile_cache  # noqa: E402

enable_compile_cache()


def timeit(fn, iters):
    import jax
    r = fn()
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn()
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
    return (time.perf_counter() - t0) / iters * 1000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impls", default="dot,split3",
                    help="comma list of exact-mode matmul lowerings: "
                         "dot | split3")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation

    N, T, P = args.batch, args.frames, args.pdfs
    fst = make_phone_lm_den_fst(num_pdfs=P)
    graph = DenominatorGraph.from_fst(fst, P)
    rng = np.random.default_rng(0)
    out = jnp.asarray(rng.normal(size=(N, T, P)).astype(np.float32) * 0.1)

    report = {"config": {"B": N, "T": T, "P": P,
                         "S": graph.num_states, "A": graph.num_transitions}}
    for impl in args.impls.split(","):
        den = DenominatorComputation(graph, leaky=1e-5, matmul_impl=impl)
        sk = den._structured
        assert sk is not None
        F = sk.lay.F
        v0 = jnp.asarray(rng.normal(size=(F, N)).astype(np.float32))

        @jax.jit
        def scan_matmuls(v, _sk=sk, _T=T):
            # T fwd + T bwd sequential dense applications, as the scans pay
            def step(c, _):
                c = _sk._apply_M(c, transpose=True)
                c = _sk._apply_M(c, transpose=False)
                # renormalize so the probabilities don't over/underflow
                return c / jnp.sum(jnp.abs(c), axis=0, keepdims=True), None
            r, _ = jax.lax.scan(step, v, None, length=_T)
            return r

        @jax.jit
        def fwd_only(x):
            return den.forward(x)

        @jax.jit
        def fwd_bwd(x):
            return den.forward_backward(x)

        report[impl] = {
            "scan_matmuls_ms": round(timeit(lambda: scan_matmuls(v0),
                                            args.iters), 2),
            "fwd_only_ms": round(timeit(lambda: fwd_only(out),
                                        args.iters), 2),
            "fwd_bwd_ms": round(timeit(lambda: fwd_bwd(out),
                                       args.iters), 2),
        }
        print(json.dumps({impl: report[impl]}), flush=True)

    print(json.dumps(report))


if __name__ == "__main__":
    main()
