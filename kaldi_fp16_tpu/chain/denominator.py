"""Probability-domain leaky-HMM denominator forward-backward (fused scans).

Redesign of the reference chain_den.cu (ref: cpp/cuda/chain_den.cu:496-699,
itself a faithful port of Kaldi chain-denominator.cc).  All six Kaldi
behaviors are preserved:

  1. probability space: x = exp(clamp(nnet, -30, 30))
  2. initial probs from the 100-iteration fp64 warmup (graph.initial)
  3. leaky HMM: alpha' = alpha + sum(alpha) * leaky * init
  4. per-frame rescale by 1/sum(alpha) with log-correction accumulation
  5. all states final: beta'[T] = 1/total_prob uniformly
  6. transition prob = exp(-tropical_weight) (baked into graph.prob)

Design (production den scale: S=7052/A=113380/P=3080).  The recursion is
a gather/scatter problem: alpha_next[dst] += alpha[src]*tp*x.  Scatter-adds
(segment_sum) are slower per step than gathers and need atomics on some
backends; per-arc row gathers are index-rate bound, so every removed
gather counts.  Design:

  * State-major [S, N] layout (states major, batch minor) so all
    per-arc reads are ROW gathers.
  * The graph is pre-padded ONCE on the host, in THREE arc orders (grouped
    by dst / src / pdf into 128-wide key blocks of 128-arc chunks, ~1.07x
    arc inflation).  Each scatter becomes a batched matmul against static
    one-hot block matrices:
        out[block] = sum_j onehot[block,j]^T @ arc_vals[block,j]
    which is deterministic (no atomics).  Padding slots have all-zero
    one-hot rows, so no masks are needed anywhere.
    The forward runs dst-native, the beta recursion src-native — each
    scan reduces into its own order with zero permutation gathers.
  * Posteriors move OUT of the sequential scan into one bulk pass over
    all frames (chunked to bound memory): with [state, time*batch]
    operand layout each gathered row is T*N wide, so the three per-arc
    reads run near HBM bandwidth instead of at index rate, and the
    per-pdf reduction is one big matmul contraction.
  * Per-arc emission scores x[pdf[a]]*tp[a] are hoisted for all T frames
    before the scans when they fit (`hoist_bytes`); otherwise gathered
    per frame from a [T, P, N] table.
  * Two modes, mirroring the reference's deterministic/atomic kernel split
    (ref: chain_det.cu):
      'exact': f32 one-hots, matmuls at chain.precision.EXACT_PRECISION
               (fp32 class) — the parity path.
      'fast':  bf16 one-hots, single-pass bf16 matmuls (arc values rounded
               to bf16 inside the matmul) — ~1e-3 relative drift,
               measured by tools/chainverify.py phase 4.
  * Batched over N sequences (the reference supports only
    num_sequences == 1, denominator.go:226-228); feed wide batches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_fp16_tpu.chain.graph import DenominatorGraph
from kaldi_fp16_tpu.chain.precision import EXACT_PRECISION

SB = 128   # state/pdf block width (matmul output tile)
AC = 128   # arcs per chunk (matmul contraction tile)


class _BlockedOrder:
    """Arcs grouped into 128-wide blocks of a sort key, padded to AC chunks.

    Per padded slot k: the canonical-arc attributes (src/dst/pdf/prob) with
    prob forced to 0 on padding slots, plus a one-hot row over the slot's
    key block ([NB, J, AC, SB], all-zero rows for padding slots) used to
    reduce arc values into per-key sums with one batched matmul.

    `secondary` orders arcs WITHIN each key block (the one-hot rows make
    within-block order irrelevant for correctness).  Sorting by the gather
    index used in that order gives the row gathers memory locality —
    measured 1.6x on the whole fwd-bwd for a locality-free random graph.
    """

    def __init__(self, keys: np.ndarray, num_keys: int, graph,
                 secondary: Optional[np.ndarray] = None, min_chunks: int = 1):
        if secondary is not None:
            order = np.lexsort((secondary, keys)).astype(np.int64)
        else:
            order = np.argsort(keys, kind="stable").astype(np.int64)
        sk = keys[order]
        NB = max(1, -(-num_keys // SB))
        bounds = np.searchsorted(sk, np.arange(0, (NB + 1) * SB, SB))
        counts = np.diff(bounds)
        J = max(min_chunks,
                int(np.max(-(-counts // AC))) if len(counts) else 1)
        Ap = NB * J * AC
        perm = np.zeros(Ap, np.int64)
        valid = np.zeros(Ap, bool)
        onehot = np.zeros((NB, J * AC, SB), np.float32)
        for b in range(NB):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            n = hi - lo
            base = b * J * AC
            perm[base:base + n] = order[lo:hi]
            valid[base:base + n] = True
            onehot[b, np.arange(n), sk[lo:hi] - b * SB] = 1.0
        self.num_blocks = NB
        self.chunks = J
        self.padded = Ap
        self.onehot = onehot.reshape(NB, J, AC, SB)
        self.src = jnp.asarray(graph.src[perm].astype(np.int32))
        self.dst = jnp.asarray(graph.dst[perm].astype(np.int32))
        self.pdf = jnp.asarray(graph.pdf[perm].astype(np.int32))
        self.prob = jnp.asarray(
            np.where(valid, graph.prob[perm], 0.0).astype(np.float32))


class DenominatorComputation:
    """Device-resident denominator graph with forward/forward-backward ops
    (the reference's NativeDenominator analog, batched over sequences)."""

    def __init__(self, graph: DenominatorGraph, leaky: float = 1e-5,
                 mode: str = "exact", hoist_bytes: int = 1 << 30,
                 layout: str = "auto", matmul_impl: str = "dot"):
        assert mode in ("exact", "fast")
        assert layout in ("auto", "structured", "blocked")
        # the blocked orders / structured layout below are derived from
        # the graph ONCE; snapshot it into private frozen copies so a
        # later caller-side mutation can't silently serve stale derived
        # state — without mutating the caller's arrays' writeable flags
        # (the caller may legitimately share or edit its own copies)
        import dataclasses
        self._source_graph = graph  # identity anchor for the jit cache
        frozen = {}
        for name in ("src", "dst", "pdf", "prob", "initial"):
            arr = np.array(getattr(graph, name), copy=True)
            arr.flags.writeable = False
            frozen[name] = arr
        graph = dataclasses.replace(graph, **frozen)
        self.graph = graph
        self.leaky = leaky
        self.mode = mode
        self.hoist_bytes = hoist_bytes
        S, P = graph.num_states, graph.num_pdfs

        # Structure-exploiting layout (chains + dense phone-LM matmul,
        # chain/den_structured.py): zero gathers/scatters in the scans.
        # Preferred whenever the graph decomposes; 'blocked' forces the
        # generic gather path (tests compare the two for parity).
        self._structured = None
        if layout in ("auto", "structured"):
            from kaldi_fp16_tpu.chain.den_structured import (
                StructuredKernels, analyze_chain_structure,
            )
            lay = analyze_chain_structure(graph)
            if lay is not None:
                self._structured = StructuredKernels(
                    lay, leaky, mode, hoist_bytes, matmul_impl=matmul_impl)
            elif layout == "structured":
                raise ValueError(
                    "layout='structured' requested but the graph does not "
                    "decompose (multi-self-loops, pdf conflicts, or too "
                    "many chains for the dense residual matrix)")
        self.layout_used = "structured" if self._structured else "blocked"
        if self._structured is not None:
            return  # blocked-order machinery not needed

        oh_dtype = jnp.float32 if mode == "exact" else jnp.bfloat16
        self._precision = (EXACT_PRECISION if mode == "exact"
                           else jax.lax.Precision.DEFAULT)

        # secondary within-block sort = the gather index each order uses
        self._dst_o = _BlockedOrder(graph.dst, S, graph, secondary=graph.src)
        self._src_o = _BlockedOrder(graph.src, S, graph, secondary=graph.dst)
        # De-alias: when the src order's padded shape coincides with the dst
        # order's, XLA merges/schedules the two identically-shaped hoist
        # gathers + scans pathologically (measured 1.6x slowdown of the
        # whole fwd-bwd, reproducible across seeds).  One extra all-padding
        # chunk (~6% more src-order work) keeps the shapes distinct.
        if self._src_o.chunks == self._dst_o.chunks:
            self._src_o = _BlockedOrder(graph.src, S, graph,
                                        secondary=graph.dst,
                                        min_chunks=self._dst_o.chunks + 1)
        self._pdf_o = _BlockedOrder(graph.pdf, P, graph, secondary=graph.src)
        self._oh_dst = jnp.asarray(self._dst_o.onehot, dtype=oh_dtype)
        self._oh_src = jnp.asarray(self._src_o.onehot, dtype=oh_dtype)
        self._oh_pdf = jnp.asarray(self._pdf_o.onehot, dtype=oh_dtype)
        self._Sp = self._dst_o.num_blocks * SB
        self._Pp = self._pdf_o.num_blocks * SB

        init_pad = np.zeros(self._Sp, np.float32)
        init_pad[:S] = graph.initial
        self._init = jnp.asarray(init_pad)

    # -- blocked one-hot reduction (the scatter replacement) -----------------

    def _reduce(self, vals: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
        """[Ap, ...] arc values -> [NB*SB, ...] per-key block sums.

        Lowered as einsums against the stored one-hot blocks.  A manual
        2-pass value split (bf16 hi+lo against bf16 one-hots) is not an
        option for exact mode: its ~2^-17/step split error compounds
        through the 49-step recursion to ~7e-4 posterior drift, outside
        the exact-mode accuracy class.
        """
        nb, j = onehot.shape[0], onehot.shape[1]
        rest = vals.shape[1:]
        v = vals.reshape(nb, j, AC, -1)
        out = jnp.einsum("bjas,bjan->bsn", onehot, v,
                         precision=self._precision,
                         preferred_element_type=jnp.float32)
        return out.reshape((nb * SB,) + rest)

    # -- core ---------------------------------------------------------------

    @functools.partial(jax.jit, static_argnames=("self", "compute_grad"))
    def _forward_backward(self, nnet_output, compute_grad: bool = True):
        """nnet_output [N, T, P] -> (log_prob [N], posteriors [N, T, P])."""
        if self._structured is not None:
            return self._structured.forward_backward(nnet_output,
                                                     compute_grad)
        N, T, P = nnet_output.shape
        Sp = self._Sp
        leaky = jnp.float32(self.leaky)
        init = self._init                                     # [Sp]
        dsto, srco, pdfo = self._dst_o, self._src_o, self._pdf_o

        # state-major: [T, P, N]
        x = jnp.exp(jnp.clip(nnet_output, -30.0, 30.0))
        x_tpn = jnp.transpose(x, (1, 2, 0))

        # hoist budget covers the two scan-order score tables
        hoist = T * (dsto.padded + srco.padded) * N * 4 <= self.hoist_bytes

        def arc_scores(xs_t, order):
            """xs_t: hoisted [Ap, N] scores, or raw [P, N] frame."""
            if hoist:
                return xs_t
            return jnp.take(xs_t, order.pdf, axis=0) * order.prob[:, None]

        def hoisted(order):
            return (jnp.take(x_tpn, order.pdf, axis=1)
                    * order.prob[None, :, None])

        xs_dst = hoisted(dsto) if hoist else x_tpn

        # ---- forward (dst-native order) -------------------------------------
        alpha0 = jnp.broadcast_to(init[:, None], (Sp, N))
        asum0 = alpha0.sum(axis=0)
        adash0 = alpha0 + asum0[None, :] * leaky * init[:, None]

        def fwd_step(carry, xs_t):
            adash_prev, asum_prev = carry
            xtp_t = arc_scores(xs_t, dsto)
            av = jnp.take(adash_prev, dsto.src, axis=0) * xtp_t   # [Ap, N]
            nxt = self._reduce(av, self._oh_dst)
            safe = asum_prev > 0
            nxt = jnp.where(safe[None, :], nxt / asum_prev[None, :], nxt)
            logc = jnp.where(safe, jnp.log(asum_prev), 0.0)
            asum = nxt.sum(axis=0)
            adash = nxt + asum[None, :] * leaky * init[:, None]
            return (adash, asum), (adash_prev, asum_prev, logc)

        (adash_T, _), (adash_hist, asum_hist, logcs) = jax.lax.scan(
            fwd_step, (adash0, asum0), xs_dst)

        total_prob = adash_T.sum(axis=0)
        log_prob = jnp.log(total_prob) + logcs.sum(axis=0)

        if not compute_grad:
            return log_prob, None

        # ---- lean backward: beta recursion only (src-native order) ----------
        # beta'[T] = 1/total_prob on all real states (all states final).
        real = (jnp.arange(Sp) < self.graph.num_states)[:, None]
        beta_dash_T = jnp.where(
            real, jnp.where(total_prob[None, :] > 0,
                            1.0 / total_prob[None, :], 0.0), 0.0)
        beta_dash_T = jnp.broadcast_to(beta_dash_T, (Sp, N))

        def leakify(bd):
            tot = leaky * (bd * init[:, None]).sum(axis=0)
            return bd + tot[None, :]

        betaT = leakify(beta_dash_T)
        xs_src = hoisted(srco) if hoist else x_tpn

        def bwd_step(beta_next, inp):
            xs_t, asum_t = inp
            xtp_t = arc_scores(xs_t, srco)
            inv = jnp.where(asum_t > 0, 1.0 / asum_t, 0.0)        # [N]
            bv = jnp.take(beta_next, srco.dst, axis=0) * xtp_t    # [Ap, N]
            bd = self._reduce(bv, self._oh_src) * inv[None, :]
            # emit the carry INPUT: frame t's posteriors use beta at t+1
            return leakify(bd), beta_next

        _, beta_hist = jax.lax.scan(bwd_step, betaT, (xs_src, asum_hist),
                                    reverse=True)

        # ---- bulk posteriors (pdf-native order, chunked over T) -------------
        # gamma[t][pdf] = alpha'[t][src] * tp * x[t][pdf] * beta[t+1][dst]
        #                 / alpha_sum[t], reduced per pdf with one matmul
        # contraction per chunk.  [state, time*batch] layout makes each
        # per-arc gather row T_c*N wide (bandwidth-bound, not index-bound).
        inv_hist = jnp.where(asum_hist > 0, 1.0 / asum_hist, 0.0)  # [T, N]
        bytes_per_frame = pdfo.padded * N * 4 * 4
        Tc = int(min(T, max(1, self.hoist_bytes // max(1, bytes_per_frame))))
        nc = -(-T // Tc)
        # balance chunks (see den_structured.py): a budget-capped Tc makes
        # the last chunk mostly padding; ceil(T/nc) keeps the same chunk
        # count with near-zero padded frames
        Tc = -(-T // nc)
        Tpad = nc * Tc

        def padT(a):
            return jnp.pad(a, [(0, Tpad - T)] + [(0, 0)] * (a.ndim - 1))

        ad_c = padT(adash_hist).reshape(nc, Tc, Sp, N)
        be_c = padT(beta_hist).reshape(nc, Tc, Sp, N)
        x_c = padT(x_tpn).reshape(nc, Tc, P, N)
        inv_c = padT(inv_hist).reshape(nc, Tc, N)

        def chunk_posts(args):
            ad, be, xf, iv = args                   # [Tc,Sp,N] ... [Tc,N]
            ad_st = jnp.transpose(ad, (1, 0, 2))    # [Sp, Tc, N]
            be_st = jnp.transpose(be, (1, 0, 2))
            x_pt = jnp.transpose(xf, (1, 0, 2))     # [P, Tc, N]
            # x[t][pdf] depends on (t, pdf) only — NOT the arc — so it
            # multiplies AFTER the per-pdf reduce (one [P, Tc, N]
            # elementwise op) instead of riding each arc as a third
            # gathered [Ap, Tc, N] operand.  1/3 less gather traffic in
            # the HBM-bound pass; tp stays per-arc but fuses into the
            # av*bt elementwise chain for free.
            av = jnp.take(ad_st, pdfo.src, axis=0)            # [Ap, Tc, N]
            bt = jnp.take(be_st, pdfo.dst, axis=0)
            gv = av * bt * pdfo.prob[:, None, None]
            red = self._reduce(gv.reshape(pdfo.padded, Tc * N),
                               self._oh_pdf)
            red = red.reshape(self._Pp, Tc, N)[:P]                                      # [P, Tc, N]
            return red * x_pt * iv[None, :, :]

        posts = jax.lax.map(chunk_posts, (ad_c, be_c, x_c, inv_c))
        # [nc, P, Tc, N] -> [N, T, P]
        posteriors = jnp.transpose(posts, (3, 0, 2, 1)).reshape(N, Tpad, P)
        return log_prob, posteriors[:, :T]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # -- public API ---------------------------------------------------------

    def forward(self, nnet_output: jnp.ndarray) -> jnp.ndarray:
        logp, _ = self._forward_backward(nnet_output, compute_grad=False)
        return logp

    def forward_backward(self, nnet_output: jnp.ndarray
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return self._forward_backward(nnet_output, compute_grad=True)


# the jit cache keys on DenominatorComputation identity (static self), so
# the functional wrapper memoizes per (graph, leaky, mode) — a fresh
# instance per call would re-run the host-side blocked-graph construction
# AND a full XLA recompile every time.  Keyed by id(graph) with the graph
# kept alive by the cache entry so ids cannot be recycled.
_den_cache: dict = {}


def denominator_forward_backward(graph: DenominatorGraph,
                                 nnet_output: jnp.ndarray,
                                 leaky: float = 1e-5,
                                 mode: str = "exact"):
    """Functional convenience wrapper; nnet_output [N, T, P]."""
    key = (id(graph), float(leaky), mode)
    hit = _den_cache.get(key)
    if hit is None or hit._source_graph is not graph:
        hit = DenominatorComputation(graph, leaky, mode)
        if len(_den_cache) > 16:
            _den_cache.clear()
        _den_cache[key] = hit
    return hit.forward_backward(nnet_output)
