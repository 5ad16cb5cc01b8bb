"""Structure-exploiting denominator layout: chains + dense phone-LM matmul.

A real den.fst (`chain-est-phone-lm | chain-make-den-fst`) is a phone-LM
over left-to-right HMM chains: most states sit on short linear chains
(self-loop + one in-chain successor), and the only fan-out is phone-end ->
phone-start transitions (ref: internal/nnet/denominator.go:83-100 models
the same graph; docs report den.fst = 7052 states / 113,380 arcs).  The
generic blocked-one-hot kernels (denominator.py) treat every arc as a
gather + matmul-reduce, so their scans are bound by the gather index
rate.  This module removes the gathers by *decomposing* the graph:

  1. **Self-loops** (src == dst): one masked elementwise multiply on a
     [L, F] chain layout (L = padded chain length, F = #chains).
  2. **Chain arcs** (the unique non-self out-arc of src AND unique
     non-self in-arc of dst): a shift along the L axis — zero gathers.
  3. **Residual arcs** (everything else): their src is always a chain END
     and their dst always a chain START (if src had another non-self
     out-arc it would not be chain-terminal; if dst had another non-self
     in-arc the chain-edge uniqueness condition would already have failed)
     — so the whole residual class is one dense [F, F] matrix applied per
     frame as one matmul, with the emission factored out per destination
     (requires every residual arc into a given dst to carry the same pdf,
     which holds for Kaldi chain topologies where non-self-loop arcs into
     an HMM state carry that state's forward-pdf).

Chains are grouped by length so "all chain ends" / "all chain starts" are
a handful of static slices — the forward AND backward recursions then
contain no gathers or scatters at all, only elementwise ops, shifts, and
one dense matmul per step.  Posterior accumulation reduces ~2S per-slot
values (instead of ~A per-arc values, a 8-16x traffic cut at production
scale) through the same blocked one-hot matmul reduction the generic path
uses.

Falls back to the generic path (analyze returns None) when: a state has
multiple self-loops, residual arcs into one dst disagree on pdf, or the
chain count exceeds `max_dense_states` (dense M too big — e.g. for the
locality-free random test graphs, which keeps the generic path covered).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def _split3_cols(v):
    """Exact 3-term bf16 decomposition along columns: [F, n] f32 -> [F, 3n].

    fp32's 24 mantissa bits decompose exactly into three bf16 terms
    (8 bits each): v == v0 + v1 + v2 up to ~2^-25 relative leftover from
    round-to-nearest.  Contrast with the 2-term hi/lo split measured in
    round 2 (denominator.py `_reduce` docstring): its ~2^-17/step
    REPRESENTATION error compounded through the 49-step recursion to
    ~7e-4 posterior drift — outside the exact class.  Three terms have no
    representation error to compound.
    """
    import jax.numpy as jnp
    v0 = v.astype(jnp.bfloat16)
    r = v - v0.astype(jnp.float32)
    v1 = r.astype(jnp.bfloat16)
    v2 = (r - v1.astype(jnp.float32)).astype(jnp.bfloat16)
    return jnp.concatenate([v0, v1, v2], axis=1)


def _split3_rows(M):
    """Exact 3-term bf16 decomposition stacked along rows: [F,F] -> [3F,F]."""
    import jax.numpy as jnp
    M = jnp.asarray(M, jnp.float32)
    M0 = M.astype(jnp.bfloat16)
    R = M - M0.astype(jnp.float32)
    M1 = R.astype(jnp.bfloat16)
    M2 = (R - M1.astype(jnp.float32)).astype(jnp.bfloat16)
    return jnp.concatenate([M0, M1, M2], axis=0)


def _matmul_split3(M3, v):
    """Exact-class [F,F] @ [F,n] as ONE default-precision bf16 matmul.

    Why: a multi-pass bf16 lowering of an fp32 dot may re-read the fp32
    matrix once per pass, and the den scan pays that T times in each
    direction.  Stacking the 3-term row split of M ([3F, F] bf16) against
    the 3-term column split of v ([F, 3n]) computes all nine cross
    products in a single bf16 matmul that reads M3 exactly once; their
    fp32-accumulated sum equals the exact product (the decompositions are
    exact), at half the matrix bytes and 9x the FLOPs of one bf16 pass.
    """
    import jax
    import jax.numpy as jnp
    F = M3.shape[1]
    vshape = v.shape
    v2d = v.reshape(F, -1)
    n = v2d.shape[1]
    V3 = _split3_cols(v2d)                                   # [F, 3n]
    out = jnp.matmul(M3, V3, precision=jax.lax.Precision.DEFAULT,
                     preferred_element_type=jnp.float32)     # [3F, 3n]
    out = out.reshape(3, F, 3, n).sum(axis=(0, 2))
    return out.reshape((F,) + vshape[1:])


@dataclass
class ChainLayout:
    """Host-side decomposition of a DenominatorGraph into chain form."""
    F: int                      # number of chains
    L: int                      # padded chain length (max over chains)
    num_states: int             # original S
    num_pdfs: int
    # state <-> slot mapping; slot = (pos k, chain f)
    pos_of_state: np.ndarray    # int32 [S]
    chain_of_state: np.ndarray  # int32 [S]
    state_of_slot: np.ndarray   # int32 [L, F], -1 for padding
    # per-slot self-loop arrays [L, F]
    self_pdf: np.ndarray        # int32 (0 where absent)
    self_coef: np.ndarray       # float32 prob * mask
    # chain (k -> k+1) arrays [max(L-1,0), F]
    fwd_pdf: np.ndarray
    fwd_coef: np.ndarray
    # residual dense part
    M: np.ndarray               # float32 [F, F]: sum prob over (end u -> start v)
    res_pdf: np.ndarray         # int32 [F] pdf of residual arcs into start of chain f
    res_mask: np.ndarray        # float32 [F]
    # chains sorted by length; groups of equal length as (len, f_lo, f_hi)
    groups: List[Tuple[int, int, int]]
    init: np.ndarray            # float32 [L, F] warmup initial probs (0 on padding)
    real: np.ndarray            # bool [L, F]

    @property
    def num_slots(self) -> int:
        return self.L * self.F


def analyze_chain_structure(graph, max_len: int = 8,
                            max_dense_states: int = 4096
                            ) -> Optional[ChainLayout]:
    """Decompose `graph` (DenominatorGraph SoA arrays) into ChainLayout,
    or None when the structured kernels don't apply."""
    S = graph.num_states
    src = np.asarray(graph.src, np.int64)
    dst = np.asarray(graph.dst, np.int64)
    pdf = np.asarray(graph.pdf, np.int64)
    prob = np.asarray(graph.prob, np.float64)
    if S == 0 or len(src) == 0:
        return None

    is_self = src == dst
    ns = ~is_self
    ns_src, ns_dst = src[ns], dst[ns]
    ns_idx = np.nonzero(ns)[0]
    out_deg = np.bincount(ns_src, minlength=S)
    in_deg = np.bincount(ns_dst, minlength=S)

    # candidate chain arcs: unique non-self out-arc of src AND unique
    # non-self in-arc of dst
    cand = (out_deg[ns_src] == 1) & (in_deg[ns_dst] == 1)
    nxt = np.full(S, -1, np.int64)          # chain successor per state
    chain_arc_of = np.full(S, -1, np.int64)  # arc index of the chain arc from s
    nxt[ns_src[cand]] = ns_dst[cand]
    chain_arc_of[ns_src[cand]] = ns_idx[cand]

    # heads: states with no incoming chain arc
    has_chain_in = np.zeros(S, bool)
    has_chain_in[ns_dst[cand]] = True
    heads = np.nonzero(~has_chain_in)[0]

    chain_of_state = np.full(S, -1, np.int64)
    pos_of_state = np.full(S, -1, np.int64)
    chains: List[List[int]] = []
    demoted_arcs: List[int] = []

    for h in heads:
        cur: List[int] = []
        s = h
        while s >= 0 and chain_of_state[s] < 0:
            if len(cur) == max_len:
                # split: the arc into s becomes residual; s starts a new chain
                prev = cur[-1]
                demoted_arcs.append(int(chain_arc_of[prev]))
                chain_arc_of[prev] = -1
                chains.append(cur)
                cur = []
            chain_of_state[s] = -2  # visiting
            cur.append(int(s))
            s = int(nxt[s])
        if cur:
            chains.append(cur)

    # pure cycles of chain arcs (never reached from a head): break them into
    # singleton chains, demoting every chain arc inside
    for s0 in range(S):
        if chain_of_state[s0] != -1:
            continue
        s = s0
        while chain_of_state[s] == -1:
            chain_of_state[s] = -2
            if chain_arc_of[s] >= 0:
                demoted_arcs.append(int(chain_arc_of[s]))
                chain_arc_of[s] = -1
            chains.append([s])
            s = int(nxt[s])

    # order chains by length (stable) so equal lengths are contiguous slices
    chains.sort(key=len)
    F = len(chains)
    if F > max_dense_states:
        return None
    L = max(len(c) for c in chains)
    groups: List[Tuple[int, int, int]] = []
    for f, c in enumerate(chains):
        for k, s in enumerate(c):
            chain_of_state[s] = f
            pos_of_state[s] = k
        if groups and groups[-1][0] == len(c):
            groups[-1] = (groups[-1][0], groups[-1][1], f + 1)
        else:
            groups.append((len(c), f, f + 1))

    # classify arcs
    chain_arc_set = set(int(a) for a in chain_arc_of if a >= 0)
    demoted = set(demoted_arcs)

    self_pdf = np.zeros((L, F), np.int64)
    self_coef = np.zeros((L, F), np.float64)
    fwd_pdf = np.zeros((max(L - 1, 1), F), np.int64)
    fwd_coef = np.zeros((max(L - 1, 1), F), np.float64)
    M = np.zeros((F, F), np.float64)
    res_pdf = np.full(F, -1, np.int64)
    res_mask = np.zeros(F, np.float64)

    # pass 1: non-self arcs (chain arcs + residual); residual fixes res_pdf
    self_arc_lists: dict = {}
    for a in range(len(src)):
        u, v, p, w = int(src[a]), int(dst[a]), int(pdf[a]), float(prob[a])
        if is_self[a]:
            self_arc_lists.setdefault(u, []).append((p, w))
            continue
        ku, fu = int(pos_of_state[u]), int(chain_of_state[u])
        kv, fv = int(pos_of_state[v]), int(chain_of_state[v])
        if a in chain_arc_set and a not in demoted:
            assert fv == fu and kv == ku + 1
            fwd_pdf[ku, fu] = p
            fwd_coef[ku, fu] = w
        else:
            # residual: src must be its chain's end, dst a chain start
            if ku != len(chains[fu]) - 1 or kv != 0:
                return None          # can't happen by construction; be safe
            if res_pdf[fv] >= 0 and res_pdf[fv] != p:
                return None          # pdf not determined by destination
            res_pdf[fv] = p
            res_mask[fv] = 1.0
            M[fu, fv] += w

    # pass 2: self-loops.  One per state fits the elementwise self slot;
    # extra self-loops of a SINGLETON chain (state is both chain end and
    # chain start — e.g. the phone-LM self-transition of a 1-state phone)
    # can ride the dense residual diagonal M[f, f] when their pdf agrees
    # with the other residual arcs into that start.
    for u, arcs in self_arc_lists.items():
        ku, fu = int(pos_of_state[u]), int(chain_of_state[u])
        singleton = len(chains[fu]) == 1
        leftover = []
        if len(arcs) > 1 and singleton:
            for p, w in arcs:
                if res_pdf[fu] < 0 or res_pdf[fu] == p:
                    res_pdf[fu] = p
                    res_mask[fu] = 1.0
                    M[fu, fu] += w
                else:
                    leftover.append((p, w))
        else:
            leftover = arcs
        if len(leftover) > 1:
            return None              # can't express >1 distinct self slots
        if leftover:
            self_pdf[ku, fu] = leftover[0][0]
            self_coef[ku, fu] = leftover[0][1]

    state_of_slot = np.full((L, F), -1, np.int64)
    init = np.zeros((L, F), np.float64)
    for f, c in enumerate(chains):
        for k, s in enumerate(c):
            state_of_slot[k, f] = s
            init[k, f] = graph.initial[s]
    real = state_of_slot >= 0

    return ChainLayout(
        F=F, L=L, num_states=S, num_pdfs=graph.num_pdfs,
        pos_of_state=pos_of_state.astype(np.int32),
        chain_of_state=chain_of_state.astype(np.int32),
        state_of_slot=state_of_slot.astype(np.int32),
        self_pdf=np.maximum(self_pdf, 0).astype(np.int32),
        self_coef=self_coef.astype(np.float32),
        fwd_pdf=np.maximum(fwd_pdf, 0).astype(np.int32),
        fwd_coef=fwd_coef.astype(np.float32),
        M=M.astype(np.float32),
        res_pdf=np.maximum(res_pdf, 0).astype(np.int32),
        res_mask=res_mask.astype(np.float32),
        groups=groups,
        init=init.astype(np.float32),
        real=real,
    )


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------

class StructuredKernels:
    """Device-side forward/backward over a ChainLayout.

    Semantics identical to the generic blocked path (all six Kaldi
    behaviors, same per-frame rescale + leaky bookkeeping — see
    denominator.py); only the *indexing structure* differs: elementwise
    self-loops, shifted chain arcs, one dense [F, F] matmul for the
    residual class, and a per-slot (~2S instead of per-arc ~A) blocked
    one-hot pdf reduction for the posteriors.
    """

    def __init__(self, layout: ChainLayout, leaky: float, mode: str,
                 hoist_bytes: int = 1 << 30, matmul_impl: str = "dot"):
        import jax
        import jax.numpy as jnp
        from kaldi_fp16_tpu.chain.precision import EXACT_PRECISION
        self.lay = layout
        self.leaky = leaky
        self.mode = mode
        self.hoist_bytes = hoist_bytes
        L, F = layout.L, layout.F
        self._precision = (EXACT_PRECISION if mode == "exact"
                           else jax.lax.Precision.DEFAULT)
        # exact-mode [F, F] matmul lowering:
        #   'dot'    one XLA dot at EXACT_PRECISION.
        #   'split3' ONE stacked [3F,F]@[F,3n] bf16 matmul (single M read,
        #            all 9 cross products at 9x the FLOPs of a bf16 pass).
        assert matmul_impl in ("dot", "split3")
        self.matmul_impl = matmul_impl if mode == "exact" else "fast"
        self._M3 = self._MT3 = None
        if self.matmul_impl == "split3":
            self._M3 = _split3_rows(layout.M)                # [3F, F] bf16
            self._MT3 = _split3_rows(layout.M.T)             # [3F, F] bf16
        self.self_pdf = jnp.asarray(layout.self_pdf.reshape(-1))    # [L*F]
        self.self_coef = jnp.asarray(layout.self_coef)              # [L, F]
        self.has_fwd = L > 1 and float(np.abs(layout.fwd_coef).sum()) > 0
        self.fwd_pdf = jnp.asarray(layout.fwd_pdf[:max(L - 1, 1)].reshape(-1))
        self.fwd_coef = jnp.asarray(layout.fwd_coef[:max(L - 1, 1)])
        m_dtype = jnp.float32 if mode == "exact" else jnp.bfloat16
        self.M = jnp.asarray(layout.M, dtype=m_dtype)               # [F, F]
        self.res_pdf = jnp.asarray(layout.res_pdf)                  # [F]
        self.res_mask = jnp.asarray(layout.res_mask)                # [F]
        self.init = jnp.asarray(layout.init)                        # [L, F]
        self.real = jnp.asarray(layout.real)                        # [L, F]
        self.groups = tuple(layout.groups)

        # blocked one-hot reduce over slots -> pdf bins (posteriors).
        # slot order: [L*F self] + [(L-1)*F fwd] + [F res]
        slot_pdf = np.concatenate([
            layout.self_pdf.reshape(-1),
            layout.fwd_pdf[:max(L - 1, 1)].reshape(-1) if self.has_fwd
            else np.zeros(0, np.int32),
            layout.res_pdf,
        ]).astype(np.int64)
        self.n_slots = len(slot_pdf)
        SB = 128
        AC = 128
        P = layout.num_pdfs
        order = np.argsort(slot_pdf, kind="stable")
        sk = slot_pdf[order]
        NB = max(1, -(-P // SB))
        bounds = np.searchsorted(sk, np.arange(0, (NB + 1) * SB, SB))
        counts = np.diff(bounds)
        J = max(1, int(np.max(-(-counts // AC))) if len(counts) else 1)
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
        self._post_perm = jnp.asarray(perm.astype(np.int32))
        self._post_valid = jnp.asarray(valid.astype(np.float32))
        self._post_onehot = jnp.asarray(
            onehot.reshape(NB, J, AC, SB),
            dtype=jnp.float32 if mode == "exact" else jnp.bfloat16)
        self._post_NB, self._post_J, self._post_Ap = NB, J, Ap
        self._Pp = NB * SB

    # ---- static slice helpers (chains grouped by length) -------------------

    def _ends(self, a):
        """[L, F, N] -> [F, N] rows = chain-end values, in chain order."""
        import jax.numpy as jnp
        parts = [a[l - 1, lo:hi] for (l, lo, hi) in self.groups]
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)

    def _scatter_ends(self, g, template):
        """[F, N] end-contributions -> [L, F, N] (inverse of _ends)."""
        out = template
        for (l, lo, hi) in self.groups:
            out = out.at[l - 1, lo:hi].add(g[lo:hi])
        return out

    def _matmul(self, M, v):
        """[F, F] @ [F, ...] with mode-dependent precision."""
        import jax.numpy as jnp
        vshape = v.shape
        r = jnp.matmul(M, v.reshape(v.shape[0], -1),
                       precision=self._precision,
                       preferred_element_type=jnp.float32)
        return r.reshape((M.shape[0],) + vshape[1:])

    def _apply_M(self, v, transpose: bool):
        """M @ v (or M.T if transpose) via the configured exact lowering."""
        if self._M3 is not None:
            return _matmul_split3(self._MT3 if transpose else self._M3, v)
        return self._matmul(self.M.T if transpose else self.M, v)

    # ---- emissions ---------------------------------------------------------

    def _emissions(self, x_tpn, hoist):
        """Per-class emission coefficient tables.

        hoisted: xs_self [T, L, F, N], xs_fwd [T, L-1, F, N],
                 xs_res [T, F, N]; else a closure computing them per frame.
        """
        import jax.numpy as jnp
        L, F = self.lay.L, self.lay.F

        def per_frame(x_pn):
            xs_self = (jnp.take(x_pn, self.self_pdf, axis=0)
                       .reshape(L, F, -1) * self.self_coef[:, :, None])
            xs_fwd = None
            if self.has_fwd:
                xs_fwd = (jnp.take(x_pn, self.fwd_pdf, axis=0)
                          .reshape(L - 1, F, -1) * self.fwd_coef[:, :, None])
            xs_res = (jnp.take(x_pn, self.res_pdf, axis=0)
                      * self.res_mask[:, None])
            return xs_self, xs_fwd, xs_res

        if not hoist:
            return per_frame, None

        T = x_tpn.shape[0]
        xs_self = (jnp.take(x_tpn, self.self_pdf, axis=1)
                   .reshape(T, L, F, -1) * self.self_coef[None, :, :, None])
        xs_fwd = None
        if self.has_fwd:
            xs_fwd = (jnp.take(x_tpn, self.fwd_pdf, axis=1)
                      .reshape(T, L - 1, F, -1)
                      * self.fwd_coef[None, :, :, None])
        xs_res = (jnp.take(x_tpn, self.res_pdf, axis=1)
                  * self.res_mask[None, :, None])
        return None, (xs_self, xs_fwd, xs_res)

    # ---- core --------------------------------------------------------------

    def forward_backward(self, nnet_output, compute_grad=True):
        """nnet_output [N, T, P] -> (log_prob [N], posteriors [N, T, P])."""
        import jax
        import jax.numpy as jnp
        lay = self.lay
        L, F, P = lay.L, lay.F, lay.num_pdfs
        N, T, _ = nnet_output.shape
        leaky = jnp.float32(self.leaky)
        init = self.init                                   # [L, F]

        x = jnp.exp(jnp.clip(nnet_output, -30.0, 30.0))
        x_tpn = jnp.transpose(x, (1, 2, 0))                # [T, P, N]

        # hoist budget: 2 passes of (2L+1)*F*N fp32 per frame
        hoist = T * (2 * L + 1) * F * N * 4 * 2 <= self.hoist_bytes

        per_frame, hoisted = self._emissions(x_tpn, hoist)

        def frame_inputs():
            if hoist:
                xs_self, xs_fwd, xs_res = hoisted
                if xs_fwd is None:
                    return (xs_self, xs_res)
                return (xs_self, xs_fwd, xs_res)
            return x_tpn

        def unpack(xs_t):
            if hoist:
                if self.has_fwd:
                    return xs_t
                xs_self, xs_res = xs_t
                return xs_self, None, xs_res
            return per_frame(xs_t)

        def propagate(adash, xs_t):
            """sum over arcs: adash[src] * prob * x[pdf]  (dst-indexed)."""
            xs_self, xs_fwd, xs_res = unpack(xs_t)
            nxt = adash * xs_self                             # self loops
            if self.has_fwd:
                nxt = nxt.at[1:].add(adash[:-1] * xs_fwd)     # chain arcs
            e = self._ends(adash)                             # [F, N]
            f = self._apply_M(e, transpose=True)              # [F, N]
            nxt = nxt.at[0].add(f * xs_res)                   # residual
            return nxt

        # ---- forward ------------------------------------------------------
        alpha0 = jnp.broadcast_to(init[:, :, None], (L, F, N))
        asum0 = alpha0.sum(axis=(0, 1))
        adash0 = alpha0 + asum0[None, None, :] * leaky * init[:, :, None]

        def fwd_step(carry, xs_t):
            adash_prev, asum_prev = carry
            nxt = propagate(adash_prev, xs_t)
            safe = asum_prev > 0
            nxt = jnp.where(safe[None, None, :],
                            nxt / asum_prev[None, None, :], nxt)
            logc = jnp.where(safe, jnp.log(asum_prev), 0.0)
            asum = nxt.sum(axis=(0, 1))
            adash = nxt + asum[None, None, :] * leaky * init[:, :, None]
            return (adash, asum), (adash_prev, asum_prev, logc)

        (adash_T, _), (adash_hist, asum_hist, logcs) = jax.lax.scan(
            fwd_step, (adash0, asum0), frame_inputs())

        total_prob = adash_T.sum(axis=(0, 1))
        log_prob = jnp.log(total_prob) + logcs.sum(axis=0)

        if not compute_grad:
            return log_prob, None

        # ---- backward (beta recursion) ------------------------------------
        real = self.real[:, :, None]
        beta_dash_T = jnp.where(
            real, jnp.where(total_prob[None, None, :] > 0,
                            1.0 / total_prob[None, None, :], 0.0), 0.0)
        beta_dash_T = jnp.broadcast_to(beta_dash_T, (L, F, N))

        def leakify(bd):
            tot = leaky * (bd * init[:, :, None]).sum(axis=(0, 1))
            return bd + tot[None, None, :]

        betaT = leakify(beta_dash_T)

        def bwd_step(beta_next, inp):
            xs_t, asum_t = inp
            xs_self, xs_fwd, xs_res = unpack(xs_t)
            inv = jnp.where(asum_t > 0, 1.0 / asum_t, 0.0)
            bd = beta_next * xs_self
            if self.has_fwd:
                bd = bd.at[:-1].add(beta_next[1:] * xs_fwd)
            h = self._apply_M(xs_res * beta_next[0],
                              transpose=False)                # [F, N] to ends
            bd = self._scatter_ends(h, bd)
            bd = bd * inv[None, None, :]
            return leakify(bd), beta_next

        _, beta_hist = jax.lax.scan(bwd_step, betaT,
                                    (frame_inputs(), asum_hist),
                                    reverse=True)

        posteriors = self._bulk_posteriors(adash_hist, asum_hist,
                                           beta_hist, x_tpn, N, T, P)
        return log_prob, posteriors

    # ---- bulk posteriors ----------------------------------------------------

    def _bulk_posteriors(self, adash_hist, asum_hist, beta_hist, x_tpn,
                         N, T, P):
        # per-slot values, reduced into pdf bins per chunk
        import jax
        import jax.numpy as jnp
        L, F = self.lay.L, self.lay.F
        inv_hist = jnp.where(asum_hist > 0, 1.0 / asum_hist, 0.0)  # [T, N]
        bytes_per_frame = self.n_slots * N * 4 * 4
        Tc = int(min(T, max(1, self.hoist_bytes // max(1, bytes_per_frame))))
        nc = -(-T // Tc)
        # balance the chunks: ceil(T/nc) instead of the budget cap, so the
        # last chunk is not mostly padding (T=49, budget Tc=35 -> chunks of
        # [35, 14+21pad]: 30% of the bulk-pass work was padding; balanced
        # Tc=25 pads a single frame)
        Tc = -(-T // nc)
        Tpad = nc * Tc

        def padT(a):
            return jnp.pad(a, [(0, Tpad - T)] + [(0, 0)] * (a.ndim - 1))

        ad_c = padT(adash_hist).reshape(nc, Tc, L, F, N)
        be_c = padT(beta_hist).reshape(nc, Tc, L, F, N)
        x_c = padT(x_tpn).reshape(nc, Tc, P, N)
        inv_c = padT(inv_hist).reshape(nc, Tc, N)

        NBp, Jp, Ap = self._post_NB, self._post_J, self._post_Ap

        def chunk_posts(args):
            ad, be, xf, iv = args                 # [Tc,L,F,N] ... [Tc,N]
            # slot values, [slots, Tc, N].  The emission x[t][pdf] factors
            # per SLOT PDF — exactly the reduce key — so it multiplies
            # AFTER the per-pdf reduce (one [P, Tc, N] elementwise op)
            # instead of riding every slot as a gathered [slots, Tc, N]
            # operand: three x-gathers and ~0.5 GB of traffic gone
            # (round 4; same trick the blocked path landed in round 2).
            x_pt = jnp.transpose(xf, (1, 0, 2))   # [P, Tc, N]
            ad_s = jnp.transpose(ad, (1, 2, 0, 3))  # [L, F, Tc, N]
            be_s = jnp.transpose(be, (1, 2, 0, 3))
            vals = [(ad_s * be_s * self.self_coef[:, :, None, None])
                    .reshape(L * F, Tc, N)]
            if self.has_fwd:
                vals.append((ad_s[:-1] * be_s[1:]
                             * self.fwd_coef[:, :, None, None])
                            .reshape((L - 1) * F, Tc, N))
            # residual: f[v] = (M^T @ adash_ends), beta factor per dst
            e = jnp.concatenate(
                [ad_s[l - 1, lo:hi] for (l, lo, hi) in self.groups], 0
            ) if len(self.groups) > 1 else ad_s[self.groups[0][0] - 1]
            fmat = self._apply_M(e.reshape(F, Tc * N), transpose=True)
            fmat = fmat.reshape(F, Tc, N)
            vals.append(fmat * be_s[0] * self.res_mask[:, None, None])
            v = jnp.concatenate(vals, 0)                     # [slots, Tc, N]
            # blocked one-hot pdf reduce (padded slot order)
            vp = (jnp.take(v.reshape(self.n_slots, Tc * N),
                           self._post_perm, axis=0)
                  * self._post_valid[:, None])
            vp = vp.reshape(NBp, Jp, Ap // (NBp * Jp), Tc * N)
            red = jnp.einsum("bjas,bjan->bsn", self._post_onehot, vp,
                             precision=self._precision,
                             preferred_element_type=jnp.float32)
            red = red.reshape(self._Pp, Tc, N)[:P]
            return red * x_pt * iv[None, :, :]

        posts = jax.lax.map(chunk_posts, (ad_c, be_c, x_c, inv_c))
        posteriors = jnp.transpose(posts, (3, 0, 2, 1)).reshape(N, Tpad, P)
        return posteriors[:, :T]
