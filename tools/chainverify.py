#!/usr/bin/env python
"""chainverify — numerical verification of the chain objective
(ref: cmd/chainverify/main.go; without a Kaldi install the oracle is the
float64 reference implementation + brute-force path enumeration + finite
differences — the same three-way check the test-suite runs, on demand and
with configurable sizes).

Phases:
  1. zero-output check: numerator/denominator logprobs vs the fp64 oracle
  2. random-output check: logprob + posterior allclose vs fp64 oracle
  3. gradient check: analytic deriv vs central finite differences
  4. reproducibility: N repeat runs of the jitted kernels must be bit-equal
     (XLA determinism — replaces the reference's atomic/det comparison),
     plus exact-vs-fast segment-mode drift measurement.

Phases 1-3 run TWICE in one invocation: first pinned to the CPU backend
at strict fp32 tolerances (~1e-6 on logprobs), then on the ambient
backend (the GPU when one is present) at --tol.  The strict CPU pass
means a genuine logic regression cannot hide inside the ambient budget;
the ambient pass means the deployed backend is still what gets gated.
"""

import argparse
import sys

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--den-fst", help="den.fst path (default: synthetic)")
    ap.add_argument("--egs", help="cegs ark with supervision FSTs (optional)")
    ap.add_argument("--pdfs", type=int, default=24)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    # ambient-backend logprob tolerance: exact-mode matmuls are fp32 class
    # (chain/precision.py) and the GPU's exp/log are within a few ulp, but
    # summation order differs from the CPU's and the error compounds over
    # the T-step recursion, so the budget is 10x the strict CPU one
    ap.add_argument("--tol", type=float, default=2e-5)
    ap.add_argument("--strict-tol", type=float, default=2e-6,
                    help="logprob tolerance for the pinned-CPU pass")
    ap.add_argument("--skip-strict", action="store_true",
                    help="skip the pinned-CPU strict pass")
    ap.add_argument("--topology", default="random",
                    choices=["random", "phone-lm"],
                    help="synthetic den graph shape: phone-lm routes to "
                         "the structured chain-decomposed kernels")
    ap.add_argument("--platform", default="ambient",
                    choices=["ambient", "cpu"],
                    help="cpu: pin the whole run to the CPU backend")
    args = ap.parse_args()

    if args.platform == "cpu":
        _common.force_cpu()

    import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, build_numerator_batch, make_simple_den_fst,
    )
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.numerator import numerator_forward_backward
    from kaldi_fp16_tpu.chain.objective import (
        ChainTrainingOpts, chain_objf_and_deriv,
    )
    from kaldi_fp16_tpu.chain.reference import (
        denominator_forward_backward_ref, numerator_forward_backward_ref,
    )
    from kaldi_fp16_tpu.io.fst import read_fst_file, Fst, FstArc, FstState
    from kaldi_fp16_tpu.io.sparse import fst_to_csr

    rng = np.random.default_rng(0)
    P, T, B = args.pdfs, args.frames, args.batch
    failures = 0

    # graph construction is backend-free (numpy); shared by both passes
    if args.den_fst:
        fst = read_fst_file(args.den_fst)
        den_graph = DenominatorGraph.from_fst(fst, args.pdfs)
    elif args.topology == "phone-lm":
        from kaldi_fp16_tpu.chain.graph import make_phone_lm_den_fst
        den_graph = DenominatorGraph.from_fst(
            make_phone_lm_den_fst(num_pdfs=P, num_phones=6,
                                  states_per_phone=2, branching=3, seed=1),
            P)
    else:
        den_graph = DenominatorGraph.from_fst(
            make_simple_den_fst(num_pdfs=P, num_states=8, seed=1), P)

    if args.egs:
        from kaldi_fp16_tpu.io.egs import read_examples
        exs = read_examples(args.egs, limit=B)
        csrs = [fst_to_csr(e.supervision.fst) for e in exs]
        T = exs[0].supervision.frames_per_seq
    else:
        def linear_fst():
            states = [FstState() for _ in range(T + 1)]
            for t in range(T):
                states[t].arcs.append(
                    FstArc(int(rng.integers(1, P + 1)), 0.3, t + 1))
                states[t].arcs.append(
                    FstArc(int(rng.integers(1, P + 1)), 1.0, t + 1))
            states[-1].final = 0.0
            return Fst(start=0, states=states)
        csrs = [fst_to_csr(linear_fst()) for _ in range(B)]
    num_graph = build_numerator_batch(csrs)

    # shared random test point so both passes verify the same numbers
    out = (rng.normal(size=(B, T, P)) * 0.5).astype(np.float32)
    zero = np.zeros((B, T, P), dtype=np.float32)
    fd_points = [(int(rng.integers(B)), int(rng.integers(T)),
                  int(rng.integers(P))) for _ in range(8)]

    def check(name, val, ref, tol):
        nonlocal failures
        err = abs(val - ref)
        ok = err <= tol * max(1.0, abs(ref))
        print(f"  {'OK ' if ok else 'FAIL'} {name}: got {val:.6f} "
              f"ref {ref:.6f} (|err|={err:.2e}, tol={tol})")
        if not ok:
            failures += 1

    def run_phases_123(tol_lp, tol_post, tol_fd):
        """Phases 1-3 on whatever backend is currently default; fresh
        DenominatorComputation so device buffers land on that backend."""
        den = DenominatorComputation(den_graph, leaky=1e-5)
        print(f"  den graph: {den_graph.num_states} states, "
              f"{den_graph.num_transitions} arcs, layout={den.layout_used}")

        print("  phase 1: zero-output logprobs vs fp64 oracle")
        num_lp, _ = numerator_forward_backward(num_graph, jnp.asarray(zero))
        den_lp = den.forward(jnp.asarray(zero))
        for b in range(B):
            ref_num, _ = numerator_forward_backward_ref(csrs[b], zero[b])
            check(f"num_logprob[{b}]", float(num_lp[b]), ref_num, tol_lp)
        ref_den, _ = denominator_forward_backward_ref(den_graph, zero[0])
        check("den_logprob", float(den_lp[0]), ref_den, tol_lp)

        print("  phase 2: random-output posteriors vs fp64 oracle")
        num_lp, num_post = numerator_forward_backward(
            num_graph, jnp.asarray(out))
        den_lp, den_post = den.forward_backward(jnp.asarray(out))
        max_num_err = max_den_err = 0.0
        for b in range(B):
            rl, rp = numerator_forward_backward_ref(csrs[b], out[b])
            check(f"num_logprob[{b}]", float(num_lp[b]), rl, tol_lp)
            max_num_err = max(max_num_err,
                              np.abs(np.asarray(num_post[b]) - rp).max())
            dl, dp = denominator_forward_backward_ref(den_graph, out[b])
            check(f"den_logprob[{b}]", float(den_lp[b]), dl, tol_lp)
            max_den_err = max(max_den_err,
                              np.abs(np.asarray(den_post[b]) - dp).max())
        print(f"    num posterior max |err| = {max_num_err:.2e}")
        print(f"    den posterior max |err| = {max_den_err:.2e}")
        ok_post = max_num_err <= tol_post and max_den_err <= tol_post
        if not ok_post:
            print(f"  FAIL posterior err exceeds {tol_post}")
        failed = 0 if ok_post else 1

        print("  phase 3: analytic deriv vs central differences")
        opts = ChainTrainingOpts(out_of_range_regularize=0.0)
        result, deriv = chain_objf_and_deriv(
            num_graph, den, jnp.asarray(out), opts=opts)
        deriv = np.asarray(deriv)
        eps = 1e-3
        worst = 0.0
        for b, t, p in fd_points:
            o1, o2 = out.copy(), out.copy()
            o1[b, t, p] -= eps
            o2[b, t, p] += eps
            r1, _ = chain_objf_and_deriv(num_graph, den, jnp.asarray(o1),
                                         opts=opts)
            r2, _ = chain_objf_and_deriv(num_graph, den, jnp.asarray(o2),
                                         opts=opts)
            fd = (float(r2.total_objf) - float(r1.total_objf)) / (2 * eps)
            worst = max(worst, abs(fd - deriv[b, t, p]))
        print(f"    max |fd - analytic| = {worst:.2e}")
        # the finite difference itself carries ~|objf|*1e-7/eps ~ 1e-3
        # fp32 noise regardless of backend, so tol_fd floors at that
        if worst > tol_fd:
            print(f"  FAIL fd err exceeds {tol_fd}")
            failed += 1
        return failed, den

    # ---- strict pass: pinned CPU, fp32-vs-fp64-oracle tolerances --------
    # a logic regression (wrong arc, wrong leaky mix, off-by-one frame)
    # shows up here at 1e-6 scale and cannot hide inside the ambient
    # budget below
    if not args.skip_strict:
        print(f"strict pass (pinned CPU, tol={args.strict_tol}):")
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            failures += run_phases_123(args.strict_tol,
                                       max(1e-5, args.strict_tol),
                                       2e-3)[0]

    # ---- budget pass: ambient backend ------------------------------------
    print(f"ambient pass (backend={jax.default_backend()}, tol={args.tol}):")
    extra, den = run_phases_123(args.tol, max(1e-5, args.tol), 2e-3)
    failures += extra

    # phase 4: reproducibility + fast-mode drift (ambient backend)
    print(f"phase 4: {args.repeats} repeat runs (bit-exactness) + fast drift")
    den_fast = DenominatorComputation(den_graph, leaky=1e-5, mode="fast")
    base_lp, base_post = den.forward_backward(jnp.asarray(out))
    for i in range(args.repeats - 1):
        lp, post = den.forward_backward(jnp.asarray(out))
        same = (np.array_equal(np.asarray(lp), np.asarray(base_lp))
                and np.array_equal(np.asarray(post), np.asarray(base_post)))
        print(f"  run {i + 2}: {'bit-identical' if same else 'MISMATCH'}")
        if not same:
            failures += 1
    f_lp, f_post = den_fast.forward_backward(jnp.asarray(out))
    drift_lp = np.abs(np.asarray(f_lp) - np.asarray(base_lp)).max()
    drift_post = np.abs(np.asarray(f_post) - np.asarray(base_post)).max()
    print(f"  fast-mode drift: logprob {drift_lp:.2e}, "
          f"posterior {drift_post:.2e}")

    print("PASS" if failures == 0 else f"FAIL ({failures})")
    sys.exit(0 if failures == 0 else 1)


if __name__ == "__main__":
    main()
