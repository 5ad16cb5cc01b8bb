"""Log-domain numerator forward-backward as a single jitted lax.scan.

Redesign of the reference's per-frame kernel-launch loop
(ref: cpp/cuda/chain.cu:368-473 — one launch per frame, atomicLogAdd):
here the whole T-recursion is ONE fused scan compiled by XLA, and the
per-frame arc reduction is exact and deterministic (XLA determinism
replaces the reference's atomic/deterministic kernel split, ref:
chain_det.cu).

Hardware mapping: numerator FSTs are tiny (~200 states / ~256 arcs per
utterance chunk, ref chain_det.cu:8-9), so state gather and scatter are
expressed as ONE-HOT MATMULS — exact, deterministic selection/summation
(no scatter atomics).  The log-sum-exp uses a per-frame
global shift; states more than ~87 nats below the frame max underflow to
log-zero, which is far below any path that matters (same effective range
as the reference's fp32 atomicLogAdd).

Shapes are fully static: B sequences, S padded states, A padded arcs, T
frames.  All arrays batched [B, ...]; masking handles padding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain.graph import LOG_ZERO, NumeratorGraphBatch
from kaldi_fp16_tpu.chain.precision import EXACT_PRECISION as _PREC


@functools.partial(jax.jit, static_argnames=("num_states",))
def _num_forward_backward(arc_src, arc_dst, arc_pdf, arc_logw, arc_mask,
                          start, final_logw, nnet_output, num_states: int):
    """Returns (total_logprob [B], posteriors [B, T, P])."""
    B, T, P = nnet_output.shape
    S = num_states
    A = arc_src.shape[1]

    # one-hot gather/scatter matrices (constant across frames): [B, A, S]
    e_src = jax.nn.one_hot(arc_src, S, dtype=jnp.float32)
    e_dst = jax.nn.one_hot(arc_dst, S, dtype=jnp.float32)
    # out-of-range pdfs (label > num_pdfs, malformed graphs) are skipped
    # like the fp64 reference skips them — the raw jit gather would clamp
    # to pdf P-1 and silently score the wrong output column
    mask = (arc_mask > 0) & (arc_pdf >= 0) & (arc_pdf < P)

    # hoisted per-arc scores for all frames: [T, B, A]
    pdf_scores = jax.vmap(lambda x_bt, pdf_b: x_bt[:, pdf_b])(
        nnet_output, arc_pdf)                                  # [B, T, A]
    scores = pdf_scores + arc_logw[:, None, :]
    scores = jnp.where(mask[:, None, :], scores, LOG_ZERO)
    scores = jnp.swapaxes(scores, 0, 1)                        # [T, B, A]

    def gather_states(vec, e):
        """vec [B, S] -> per-arc values [B, A] via one-hot matmul (exact)."""
        return jnp.einsum("bas,bs->ba", e, vec, precision=_PREC)

    def scatter_lse(vals, e):
        """Segment-logsumexp of per-arc log values into states: [B, S].

        Global per-row shift; masked/log-zero arcs contribute exactly 0."""
        m = jnp.max(jnp.where(mask, vals, LOG_ZERO), axis=1, keepdims=True)
        m = jnp.maximum(m, -1e28)  # all-dead frame guard
        p = jnp.where(mask & (vals > LOG_ZERO), jnp.exp(vals - m), 0.0)
        sums = jnp.einsum("ba,bas->bs", p, e, precision=_PREC)
        return jnp.where(sums > 0, m + jnp.log(sums), LOG_ZERO)

    alpha0 = jnp.full((B, S), LOG_ZERO, dtype=jnp.float32)
    alpha0 = alpha0.at[jnp.arange(B), start].set(0.0)

    def fwd_step(alpha, score_t):
        src_alpha = gather_states(alpha, e_src)
        vals = jnp.where(src_alpha > LOG_ZERO, src_alpha + score_t, LOG_ZERO)
        return scatter_lse(vals, e_dst), alpha

    alpha_T, alphas = jax.lax.scan(fwd_step, alpha0, scores)
    # alphas: [T, B, S] = alpha[0..T-1]; alpha_T = alpha[T]

    total = jax.vmap(lambda a, f: jax.scipy.special.logsumexp(
        jnp.where(f > LOG_ZERO, a + f, -jnp.inf)))(alpha_T, final_logw)
    total = jnp.where(jnp.isfinite(total), total, LOG_ZERO)

    betaT = jnp.where(final_logw > LOG_ZERO, final_logw, LOG_ZERO)

    def bwd_step(beta_next, score_t):
        dst_beta = gather_states(beta_next, e_dst)
        vals = jnp.where(dst_beta > LOG_ZERO, dst_beta + score_t, LOG_ZERO)
        beta_t = scatter_lse(vals, e_src)
        # emit the carry INPUT: frame t's posteriors use beta at t+1
        return beta_t, beta_next

    _, beta_hist = jax.lax.scan(bwd_step, betaT, scores, reverse=True)

    # bulk posteriors over all frames (no per-step scatter in the scan):
    # arc_post[t, b, a] then ONE exact one-hot contraction into pdfs
    src_alpha = jnp.einsum("bas,tbs->tba", e_src, alphas, precision=_PREC)
    dst_beta = jnp.einsum("bas,tbs->tba", e_dst, beta_hist, precision=_PREC)
    lp = jnp.where((src_alpha > LOG_ZERO) & (dst_beta > LOG_ZERO),
                   src_alpha + scores + dst_beta - total[None, :, None],
                   -jnp.inf)
    lp = jnp.minimum(lp, 0.0)                                  # clamp (chain.cu:311)
    arc_post = jnp.where(jnp.isfinite(lp), jnp.exp(lp), 0.0)   # [T, B, A]
    e_pdf = jax.nn.one_hot(jnp.where(mask, arc_pdf, P), P,
                           dtype=jnp.float32)                  # [B, A, P]
    posts = jnp.einsum("tba,bap->tbp", arc_post, e_pdf, precision=_PREC)
    posteriors = jnp.swapaxes(posts, 0, 1)                     # [B, T, P]
    ok = total > LOG_ZERO
    posteriors = jnp.where(ok[:, None, None], posteriors, 0.0)
    return total, posteriors


def numerator_forward_backward(graph: NumeratorGraphBatch,
                               nnet_output: jnp.ndarray
                               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched log-domain forward-backward.

    nnet_output: [B, T, P] float32.
    Returns (total_logprob [B], posteriors [B, T, P]).
    """
    return _num_forward_backward(
        jnp.asarray(graph.arc_src), jnp.asarray(graph.arc_dst),
        jnp.asarray(graph.arc_pdf), jnp.asarray(graph.arc_logw),
        jnp.asarray(graph.arc_mask), jnp.asarray(graph.start),
        jnp.asarray(graph.final_logw), nnet_output,
        num_states=graph.num_states)
