"""Batched on-device Viterbi over dense decoding graphs.

For decoding graphs that fit a dense state table (S up to a few thousand —
epsilon-free, or epsilon-closed offline), the max-plus recursion runs as a
single jitted lax.scan on device over a batch of utterances:

    score[t+1, d] = max_s ( score[t, s] + trans[s, d] + acoustic[t, pdf(s,d)] )

The dense [S, S] transition/pdf tables are built once from a DecodingGraph
(taking the best arc per (src, dst) pair, exact for determinized graphs).
Backpointers are returned to the host for traceback; the host-side
ViterbiDecoder (viterbi.py) remains the general sparse/beam reference.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_fp16_tpu.decode.graph import DecodingGraph

NEG_INF = -1.0e30


@dataclass
class DenseGraph:
    """Dense max-plus form of a decoding graph."""
    trans: np.ndarray      # [S, S] float32: -graph_cost, NEG_INF if no arc
    pdf: np.ndarray        # [S, S] int32: acoustic row for the arc (or 0)
    ilabel: np.ndarray     # [S, S] int32: input label of the best arc
    olabel: np.ndarray     # [S, S] int32: output label of the best arc
    final: np.ndarray      # [S] float32: -final_cost, NEG_INF if not final
    start: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    @classmethod
    def from_graph(cls, g: DecodingGraph) -> "DenseGraph":
        """Best emitting arc per (src, dst); requires an epsilon-free graph
        (compose/epsilon-remove offline for HCLG with eps arcs)."""
        S = g.num_states
        if len(g.eps_dst):
            raise ValueError("dense decoder requires an epsilon-free graph")
        trans = np.full((S, S), NEG_INF, dtype=np.float32)
        pdf = np.zeros((S, S), dtype=np.int32)
        ilabel = np.zeros((S, S), dtype=np.int32)
        olabel = np.zeros((S, S), dtype=np.int32)
        for s in range(S):
            for a in range(g.em_row_ptr[s], g.em_row_ptr[s + 1]):
                d = int(g.em_dst[a])
                w = -float(g.em_weight[a])
                if w > trans[s, d]:
                    trans[s, d] = w
                    pdf[s, d] = g.pdf_of(int(g.em_ilabel[a]))
                    ilabel[s, d] = int(g.em_ilabel[a])
                    olabel[s, d] = int(g.em_olabel[a])
        final = np.where(np.isfinite(g.final_cost), -g.final_cost,
                         NEG_INF).astype(np.float32)
        return cls(trans=trans, pdf=pdf, ilabel=ilabel, olabel=olabel,
                   final=final, start=g.start)


@functools.partial(jax.jit, static_argnames=())
def _viterbi_scan(trans, pdf, final, start, loglikes, acoustic_scale):
    """loglikes [B, T, P] -> (best_score [B], backptr [B, T, S], last [B])."""
    B, T, P = loglikes.shape
    S = trans.shape[0]

    score0 = jnp.full((B, S), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[:, start].set(0.0)

    def step(score, ll_t):
        # acoustic contribution per (s, d): scale * ll[pdf[s, d]]
        ac = acoustic_scale * ll_t[:, pdf]               # [B, S, S]
        cand = score[:, :, None] + trans[None] + ac      # [B, S, S]
        best = cand.max(axis=1)                          # [B, S] over src
        bp = cand.argmax(axis=1).astype(jnp.int32)       # [B, S]
        return best, bp

    final_score, bps = jax.lax.scan(step, score0,
                                    jnp.swapaxes(loglikes, 0, 1))
    total = final_score + final[None]
    last = total.argmax(axis=1).astype(jnp.int32)
    best = total.max(axis=1)
    return best, jnp.swapaxes(bps, 0, 1), last


class DenseViterbiDecoder:
    """Full (unpruned) batched Viterbi on device; exact best path."""

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0):
        self.dense = DenseGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        self._trans = jnp.asarray(self.dense.trans)
        self._pdf = jnp.asarray(self.dense.pdf)
        self._final = jnp.asarray(self.dense.final)

    def decode_batch(self, loglikes) -> List[dict]:
        """loglikes [B, T, P] -> list of {words, alignment, total_cost}."""
        ll = jnp.asarray(loglikes, dtype=jnp.float32)
        best, bps, last = _viterbi_scan(
            self._trans, self._pdf, self._final,
            jnp.asarray(self.dense.start, jnp.int32), ll,
            jnp.asarray(self.acoustic_scale, jnp.float32))
        best = np.asarray(best)
        bps = np.asarray(bps)
        last = np.asarray(last)
        B, T, _ = bps.shape
        results = []
        for b in range(B):
            states = np.zeros(T + 1, dtype=np.int32)
            states[T] = last[b]
            for t in range(T - 1, -1, -1):
                states[t] = bps[b, t, states[t + 1]]
            words, align = [], []
            for t in range(T):
                s, d = states[t], states[t + 1]
                ol = int(self.dense.olabel[s, d])
                # the arc's true input label (pdf+1 only when no
                # ilabel_to_pdf map exists — transition-id graphs differ)
                align.append(int(self.dense.ilabel[s, d]))
                if ol > 0:
                    words.append(ol)
            results.append({"words": words, "alignment": align,
                            "total_cost": -float(best[b]),
                            "final_reached": bool(np.isfinite(-best[b]))
                            and best[b] > NEG_INF / 2})
        return results


# ---------------------------------------------------------------------------
# Sparse arc-parallel Viterbi — the production on-device decoder.
#
# The dense [S, S] formulation above gathers ll[pdf[s, d]] into a [B, S, S]
# intermediate every frame (537 MB/frame at S=2048, B=32) and ships a
# [B, T, S] backpointer table to the host: measured 25.5 s for a
# 32x500-frame batch.  This decoder applies the chain-kernel design
# instead (SURVEY.md §7 stage 5 philosophy): arcs as a flat list sorted
# by destination, scores state-major [S, B], per-frame per-arc gathers +
# a segment-max into the destination states, and the traceback as a
# second (reverse) on-device scan so only [T, B] arc ids ever cross the
# host boundary.
# ---------------------------------------------------------------------------


@dataclass
class ArcGraph:
    """Flat arc-list (dst-sorted) max-plus form of a decoding graph."""
    src: np.ndarray        # [A] int32
    dst: np.ndarray        # [A] int32, ascending
    pdf: np.ndarray        # [A] int32 acoustic row
    ilabel: np.ndarray     # [A] int32
    olabel: np.ndarray     # [A] int32
    weight: np.ndarray     # [A] float32, -graph_cost (max-plus)
    final: np.ndarray      # [S] float32, -final_cost or NEG_INF
    start: int
    num_states: int

    @classmethod
    def from_graph(cls, g: DecodingGraph) -> "ArcGraph":
        if len(g.eps_dst):
            raise ValueError("arc decoder requires an epsilon-free graph")
        S = g.num_states
        A = len(g.em_dst)
        src = np.repeat(np.arange(S, dtype=np.int32),
                        np.diff(g.em_row_ptr).astype(np.int64))
        if g.ilabel_to_pdf is not None:
            pdf = g.ilabel_to_pdf[g.em_ilabel].astype(np.int32)
        else:
            pdf = (g.em_ilabel - 1).astype(np.int32)
        order = np.argsort(g.em_dst, kind="stable").astype(np.int64)
        final = np.where(np.isfinite(g.final_cost), -g.final_cost,
                         NEG_INF).astype(np.float32)
        assert A == len(src)
        return cls(src=src[order], dst=g.em_dst[order].astype(np.int32),
                   pdf=pdf[order], ilabel=g.em_ilabel[order].astype(np.int32),
                   olabel=g.em_olabel[order].astype(np.int32),
                   weight=(-g.em_weight[order]).astype(np.float32),
                   final=final, start=g.start, num_states=S)


# ---------------------------------------------------------------------------
# ELL (padded in-arc) layout — the scatter-free production kernel.
#
# The segment-reduce kernels below (`_arc_viterbi`) pay XLA's scatter
# lowering for segment_max/segment_min every frame, which ran far below
# the gather rate where it was measured.  The same lesson as the chain
# denominator (avoid per-frame scatters) applies: group each
# state's IN-arcs into a padded [S_b, D_b] table (buckets by
# next-pow2(in-degree) bound the padding waste at 2x), so the per-frame
# update is gathers + an axis-max — no scatter anywhere:
#
#     cand[s, i] = score[src[s, i]] + w[s, i] + scale * ll[pdf[s, i]]
#     nxt[s]     = max_i cand[s, i];  bp[s] = arc[s, argmax_i cand[s, i]]
#
# Outputs from the buckets are concatenated (states permuted by bucket) and
# un-permuted with one [S, B] gather.  Tie-breaking matches the segment
# kernel: ELL columns hold a state's in-arcs in ascending arc-id order and
# argmax returns the first maximum, i.e. the smallest winning arc id.
# ---------------------------------------------------------------------------


@dataclass
class EllGraph:
    """Degree-bucketed padded adjacency of an ArcGraph.

    Each bucket b holds the states whose degree rounds up to the same
    power of two D_b, as [S_b, D_b] tables.  `src` entries are ORIGINAL
    state ids (scores stay in original numbering; only the concatenated
    bucket OUTPUT is permuted, undone by the `new_of_old` gather).  `arc`
    entries are ArcGraph arc indices (len(arcs) == pad sentinel).
    Padding: src=0, pdf=0, weight=NEG_INF (max-plus: never wins)."""
    src: Tuple[np.ndarray, ...]     # [S_b, D_b] int32 each
    pdf: Tuple[np.ndarray, ...]
    weight: Tuple[np.ndarray, ...]  # max-plus (-cost), NEG_INF pad
    arc: Tuple[np.ndarray, ...]
    new_of_old: np.ndarray          # [S] int32: orig state -> bucket row
    num_states: int
    num_arcs: int

    @classmethod
    def from_arcs(cls, a: "ArcGraph", direction: str = "in") -> "EllGraph":
        """direction='in': rows are destination states, `src` holds arc
        sources (forward/Viterbi).  direction='out': rows are source
        states, `src` holds arc destinations (beta recursion)."""
        A = len(a.src)
        S = a.num_states
        if A == 0:
            # degenerate graph (states, no emitting arcs): one all-pad
            # bucket so the kernels still trace; nothing ever wins a max
            return cls(src=(np.zeros((S, 1), np.int32),),
                       pdf=(np.zeros((S, 1), np.int32),),
                       weight=(np.full((S, 1), NEG_INF, np.float32),),
                       arc=(np.zeros((S, 1), np.int32),),
                       new_of_old=np.arange(S, dtype=np.int32),
                       num_states=S, num_arcs=0)
        if direction == "in":
            order = np.arange(A, dtype=np.int64)   # already dst-sorted
            key, other = a.dst, a.src
        else:
            order = np.argsort(a.src, kind="stable").astype(np.int64)
            key, other = a.src[order], a.dst[order]
        deg = np.bincount(key, minlength=S).astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(deg)])
        d_of = np.where(deg <= 1, 1,
                        2 ** np.ceil(np.log2(np.maximum(deg, 1))
                                     ).astype(np.int64))
        srcs, pdfs, ws, arcs = [], [], [], []
        state_order = []
        for D in sorted(set(d_of.tolist())):
            st = np.nonzero(d_of == D)[0]
            state_order.append(st)
            idx = row_ptr[st][:, None] + np.arange(D)[None, :]
            valid = np.arange(D)[None, :] < deg[st][:, None]
            pos = order[np.minimum(idx, max(A - 1, 0))]   # ArcGraph index
            srcs.append(np.where(valid, other[np.minimum(idx, max(A - 1, 0))],
                                 0).astype(np.int32))
            pdfs.append(np.where(valid, a.pdf[pos], 0).astype(np.int32))
            ws.append(np.where(valid, a.weight[pos],
                               NEG_INF).astype(np.float32))
            arcs.append(np.where(valid, pos, A).astype(np.int32))
        perm = np.concatenate(state_order) if state_order else \
            np.zeros(0, np.int64)
        new_of_old = np.empty(S, np.int32)
        new_of_old[perm] = np.arange(S, dtype=np.int32)
        return cls(src=tuple(srcs), pdf=tuple(pdfs), weight=tuple(ws),
                   arc=tuple(arcs), new_of_old=new_of_old,
                   num_states=S, num_arcs=A)

    def device_arrays(self):
        return (tuple(jnp.asarray(x) for x in self.src),
                tuple(jnp.asarray(x) for x in self.pdf),
                tuple(jnp.asarray(x) for x in self.weight),
                tuple(jnp.asarray(x) for x in self.arc),
                jnp.asarray(self.new_of_old))


def _ell_gather(table, rows_flat, shape_b):
    return jnp.take(table, rows_flat, axis=0).reshape(shape_b)


@functools.partial(jax.jit, static_argnames=("num_states",))
def _ell_viterbi(bsrc, bpdf, bw, barc, new_of_old, src_of_arc, final,
                 start, loglikes, acoustic_scale, num_states: int):
    """loglikes [B, T, P] -> (best [B], last [B], arcs_taken [T, B]);
    scatter-free ELL forward + on-device traceback."""
    B, T, P = loglikes.shape
    S = num_states
    A = src_of_arc.shape[0]
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [T, P, B]

    score0 = jnp.full((S, B), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[start, :].set(0.0)

    def step(score, ll_t):
        outs, bps = [], []
        for src_b, pdf_b, w_b, arc_b in zip(bsrc, bpdf, bw, barc):
            sb = src_b.shape + (B,)
            cand = (_ell_gather(score, src_b.reshape(-1), sb)
                    + w_b[..., None]
                    + acoustic_scale
                    * _ell_gather(ll_t, pdf_b.reshape(-1), sb))  # [Sb,Db,B]
            outs.append(cand.max(axis=1))
            arg = cand.argmax(axis=1).astype(jnp.int32)          # [Sb, B]
            # bp = arc_b[row, arg] as one flat gather (take_along_axis
            # over a broadcast [Sb,Db,B] tensor produced a pathological
            # XLA program at HCLG scale)
            rows = jnp.arange(arc_b.shape[0], dtype=jnp.int32)[:, None]
            bps.append(jnp.take(arc_b.reshape(-1),
                                rows * arc_b.shape[1] + arg))
        nxt = jnp.take(jnp.concatenate(outs, axis=0), new_of_old, axis=0)
        bp = jnp.take(jnp.concatenate(bps, axis=0), new_of_old, axis=0)
        return nxt, bp

    final_score, bps = jax.lax.scan(step, score0, ll_tpb)
    total = final_score + final[:, None]
    best = total.max(axis=0)
    last = total.argmax(axis=0).astype(jnp.int32)

    def back_step(state, bp_t):
        arc = jnp.take_along_axis(bp_t, state[None, :], axis=0)[0]
        safe = jnp.clip(arc, 0, A - 1)
        prev = jnp.where(arc < A, jnp.take(src_of_arc, safe), state)
        return prev, arc

    _, arcs_taken = jax.lax.scan(back_step, last, bps, reverse=True)
    return best, last, arcs_taken


# ---------------------------------------------------------------------------
# Tree-ELL (capped-width, multi-level) layout — the HCLG-scale kernel.
#
# The plain ELL above buckets states by next_pow2(in-degree) with NO cap:
# a backoff-like state with 100K in-arcs creates a [1, 131072] bucket and
# log2(degmax) distinct bucket subgraphs — the compile blow-up observed at
# S=100K.
# Here every row is capped at `max_width` slots; a state whose degree
# exceeds the cap gets ceil(deg/W) level-1 rows, and further levels reduce
# each state's partials (again in <=W rows) until one row per state
# remains, ending state-ordered.  Each level is pure gathers + an
# axis-max over a <=W axis — no scatter anywhere, bucket count bounded by
# log2(W) per level, level count by ceil(log_W(degmax)).  Tie-break
# matches the segment kernel (smallest winning arc id): rows hold a
# state's arcs in ascending-id chunks, levels list chunks in ascending
# order, and argmax returns the first maximum.
# ---------------------------------------------------------------------------


@dataclass
class TreeEllGraph:
    """Capped-width padded adjacency with reduction levels.

    Level 1: width-bucketed [R_b, W_b] tables over ARC slots (src state
    to gather scores from, pdf, max-plus weight, ArcGraph arc id; pads:
    src=0, pdf=0, weight=NEG_INF, arc=A).  `levels`: per reduce level, a
    tuple of width-bucketed [R_b, W_b] int32 tables whose entries index
    the PREVIOUS level's concatenated row outputs (pad = R_prev, which
    gathers a sentinel row appended at compute time).  The final level
    has exactly one row per state, in state order.

    `row_state`: per level-1 bucket, the [R_b] OWNING state of each row
    (the reduction target: dst for direction='in', src for 'out') — the
    lattice keep-mask kernel gathers alpha at it once per row instead
    of once per arc (see _tree_min_step_mask)."""
    src: Tuple[np.ndarray, ...]
    pdf: Tuple[np.ndarray, ...]
    weight: Tuple[np.ndarray, ...]
    arc: Tuple[np.ndarray, ...]
    levels: Tuple[Tuple[np.ndarray, ...], ...]
    num_states: int
    num_arcs: int
    max_width: int
    row_state: Tuple[np.ndarray, ...] = ()

    @classmethod
    def from_arcs(cls, a: "ArcGraph", direction: str = "in",
                  max_width: int = 128) -> "TreeEllGraph":
        A = len(a.src)
        S = a.num_states
        W = max(int(max_width), 2)
        if A == 0:
            return cls(src=(np.zeros((S, 1), np.int32),),
                       pdf=(np.zeros((S, 1), np.int32),),
                       weight=(np.full((S, 1), NEG_INF, np.float32),),
                       arc=(np.zeros((S, 1), np.int32),),
                       levels=(), num_states=S, num_arcs=0, max_width=W,
                       row_state=(np.arange(S, dtype=np.int32),))
        if direction == "in":
            order = np.arange(A, dtype=np.int64)   # already dst-sorted
            key, other = a.dst, a.src
        else:
            order = np.argsort(a.src, kind="stable").astype(np.int64)
            key, other = a.src[order], a.dst[order]
        deg = np.bincount(key, minlength=S).astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(deg)])

        def split_rows(counts, item_ptr):
            """Chunk each state's contiguous item run into rows of <= W.
            Returns (row_state, row_rank, row_start, row_len); every
            state gets >= 1 row (a zero-length all-pad row if empty)."""
            r = np.maximum((counts + W - 1) // W, 1)
            R = int(r.sum())
            rs = np.repeat(np.arange(S, dtype=np.int64), r)
            rk = np.arange(R, dtype=np.int64) - np.repeat(
                np.cumsum(r) - r, r)
            start = item_ptr[rs] + rk * W
            length = np.clip(counts[rs] - rk * W, 0, W)
            return rs, rk, start, length

        def bucket_tables(start, length, fill):
            """Width-bucket rows (stable: row order preserved within a
            bucket) and build padded slot tables via
            `fill(slots, valid, rows)`.  Returns
            (tables_per_bucket, out_order_of_rows)."""
            width = np.where(length <= 1, 1,
                             2 ** np.ceil(np.log2(np.maximum(length, 1))
                                          ).astype(np.int64))
            out_order = np.argsort(width, kind="stable").astype(np.int64)
            tables = []
            for D in sorted(set(width.tolist())):
                rows = out_order[width[out_order] == D]
                slots = start[rows][:, None] + np.arange(D)[None, :]
                valid = np.arange(D)[None, :] < length[rows][:, None]
                tables.append(fill(slots, valid, rows))
            return tables, out_order

        # ---- level 1: arc slots ----------------------------------------
        rs, rk, start, length = split_rows(deg, row_ptr)
        srcs, pdfs, ws, arcs, rstates = [], [], [], [], []

        def fill_l1(slots, valid, rows):
            safe = np.minimum(slots, max(A - 1, 0))
            pos = order[safe]
            srcs.append(np.where(valid, other[safe], 0).astype(np.int32))
            pdfs.append(np.where(valid, a.pdf[pos], 0).astype(np.int32))
            ws.append(np.where(valid, a.weight[pos],
                               NEG_INF).astype(np.float32))
            arcs.append(np.where(valid, pos, A).astype(np.int32))
            rstates.append(rs[rows].astype(np.int32))
            return None

        _, out_order = bucket_tables(start, length, fill_l1)
        state_out = rs[out_order]      # state of each concatenated out row
        rank_out = rk[out_order]       # ascending-arc chunk index in state
        R_prev = len(state_out)

        # ---- reduce levels: until one state-ordered row per state ------
        levels = []
        while not (R_prev == S
                   and np.array_equal(state_out, np.arange(S))):
            item_order = np.lexsort((rank_out, state_out))  # state-major
            counts = np.bincount(state_out, minlength=S).astype(np.int64)
            iptr = np.concatenate([[0], np.cumsum(counts)])
            rs, rk, start, length = split_rows(counts, iptr)
            entries = []

            def fill_lvl(slots, valid, rows, _entries=entries,
                         _item_order=item_order, _R=R_prev):
                safe = np.minimum(slots, max(_R - 1, 0))
                _entries.append(np.where(valid, _item_order[safe],
                                         _R).astype(np.int32))
                return None

            _, out_order = bucket_tables(start, length, fill_lvl)
            levels.append(tuple(entries[i] for i in range(len(entries))))
            state_out = rs[out_order]
            rank_out = rk[out_order]
            R_prev = len(state_out)

        return cls(src=tuple(srcs), pdf=tuple(pdfs), weight=tuple(ws),
                   arc=tuple(arcs), levels=tuple(levels),
                   num_states=S, num_arcs=A, max_width=W,
                   row_state=tuple(rstates))

    def device_arrays(self):
        j = jnp.asarray
        return (tuple(j(x) for x in self.src),
                tuple(j(x) for x in self.pdf),
                tuple(j(x) for x in self.weight),
                tuple(j(x) for x in self.arc),
                tuple(tuple(j(x) for x in lvl) for lvl in self.levels))


def _onehot_pick(table_b, arg, fill=0):
    """Select table_b[r, arg[r, b]] for every (r, b) WITHOUT an
    element-level gather: flat `jnp.take(tbl, rows * D + arg)` runs at
    the scalar index rate (~200M elem/s) and was measured to cost 22 of
    the tree step's 26 ms/frame at S=100K (profile_tree.py, r3) — the
    one-hot select is a vectorized masked sum over the <=W row width at
    memory bandwidth instead.  table_b: [R, D] or [R, D, B]; arg [R, B]."""
    D = table_b.shape[1]
    if table_b.ndim == 2:
        table_b = table_b[:, :, None]
    if D == 1:
        return jnp.broadcast_to(table_b[:, 0], arg.shape)
    onehot = (jnp.arange(D, dtype=jnp.int32)[None, :, None]
              == arg[:, None, :])                            # [R, D, B]
    return jnp.where(onehot, table_b, fill).sum(axis=1)


def _tree_max_step(bsrc, bpdf, bw, barc, levels, num_arcs, score, ll_t,
                   acoustic_scale):
    """One tree-ELL max-plus update: score [S, B], ll_t [P, B] ->
    (next score [S, B], winning ArcGraph arc id [S, B], pad = A)."""
    B = score.shape[1]
    outs, arcs = [], []
    for src_b, pdf_b, w_b, arc_b in zip(bsrc, bpdf, bw, barc):
        Rb, Db = src_b.shape
        sb = (Rb, Db, B)
        cand = (_ell_gather(score, src_b.reshape(-1), sb)
                + w_b[..., None]
                + acoustic_scale
                * _ell_gather(ll_t, pdf_b.reshape(-1), sb))
        outs.append(cand.max(axis=1))
        arg = cand.argmax(axis=1).astype(jnp.int32)          # [Rb, B]
        arcs.append(_onehot_pick(arc_b, arg))
    vals = jnp.concatenate(outs, axis=0)
    arc = jnp.concatenate(arcs, axis=0)
    for lvl in levels:
        vals_p = jnp.concatenate(
            [vals, jnp.full((1, B), NEG_INF, vals.dtype)], axis=0)
        arc_p = jnp.concatenate(
            [arc, jnp.full((1, B), num_arcs, arc.dtype)], axis=0)
        outs, arcs = [], []
        for idx_b in lvl:
            Rb, Db = idx_b.shape
            g = _ell_gather(vals_p, idx_b.reshape(-1), (Rb, Db, B))
            ga = _ell_gather(arc_p, idx_b.reshape(-1), (Rb, Db, B))
            if Db == 1:
                outs.append(g[:, 0])
                arcs.append(ga[:, 0])
                continue
            outs.append(g.max(axis=1))
            arg = g.argmax(axis=1).astype(jnp.int32)
            arcs.append(_onehot_pick(ga, arg))
        vals = jnp.concatenate(outs, axis=0)
        arc = jnp.concatenate(arcs, axis=0)
    return jnp.maximum(vals, NEG_INF), arc


def _tree_min_step(bsrc, bpdf, bw, levels, score, ll_t, acoustic_scale):
    """Tree-ELL min-plus reduction (cost space, no arc tracking):
    score [S, B] costs, ll_t [P, B] acoustic costs -> next [S, B]."""
    B = score.shape[1]
    INF = jnp.float32(-NEG_INF)
    outs = []
    for src_b, pdf_b, w_b in zip(bsrc, bpdf, bw):
        Rb, Db = src_b.shape
        sb = (Rb, Db, B)
        cand = (_ell_gather(score, src_b.reshape(-1), sb)
                + (-w_b)[..., None]
                + acoustic_scale
                * _ell_gather(ll_t, pdf_b.reshape(-1), sb))
        outs.append(cand.min(axis=1))
    vals = jnp.concatenate(outs, axis=0)
    for lvl in levels:
        vals_p = jnp.concatenate(
            [vals, jnp.full((1, B), INF, vals.dtype)], axis=0)
        outs = []
        for idx_b in lvl:
            Rb, Db = idx_b.shape
            g = _ell_gather(vals_p, idx_b.reshape(-1), (Rb, Db, B))
            outs.append(g.min(axis=1))
        vals = jnp.concatenate(outs, axis=0)
    return jnp.minimum(vals, INF)


def _tree_min_step_mask(bstate, bpdf, bw, brow, levels, score, alpha_t,
                        ll_t, acoustic_scale, thr):
    """_tree_min_step over the OUT-direction tables that ALSO emits the
    lattice keep-mask, in level-1 slot order.

    The level-1 slot candidate is already arc_cost + beta_{t+1}[dst]
    (the per-arc quantity the keep criterion needs), so the test
    `alpha_t[src] + cand <= thr` costs ONE extra gather per level-1 ROW
    (alpha at the row's owning src state, broadcast across its <= W
    slots) instead of the segment kernel's 3 gathers per ARC.  Pads
    never fire: their weight is NEG_INF so cand = +inf.  Returns
    (reduced beta [S, B], keep [total_slots, B] bool); the host maps
    slot bits back to arc ids via TreeEllGraph.arc."""
    B = score.shape[1]
    INF = jnp.float32(-NEG_INF)
    outs, keeps = [], []
    for st_b, pdf_b, w_b, row_b in zip(bstate, bpdf, bw, brow):
        Rb, Db = st_b.shape
        sb = (Rb, Db, B)
        cand = (_ell_gather(score, st_b.reshape(-1), sb)
                + (-w_b)[..., None]
                + acoustic_scale
                * _ell_gather(ll_t, pdf_b.reshape(-1), sb))
        outs.append(cand.min(axis=1))
        row_alpha = jnp.take(alpha_t, row_b, axis=0)          # [Rb, B]
        keeps.append((row_alpha[:, None, :] + cand
                      <= thr[None, None, :]).reshape(Rb * Db, B))
    vals = jnp.concatenate(outs, axis=0)
    keep = jnp.concatenate(keeps, axis=0)
    for lvl in levels:
        vals_p = jnp.concatenate(
            [vals, jnp.full((1, B), INF, vals.dtype)], axis=0)
        outs = []
        for idx_b in lvl:
            Rb, Db = idx_b.shape
            g = _ell_gather(vals_p, idx_b.reshape(-1), (Rb, Db, B))
            outs.append(g.min(axis=1))
        vals = jnp.concatenate(outs, axis=0)
    return jnp.minimum(vals, INF), keep


@functools.partial(jax.jit, static_argnames=("num_states",))
def _tree_viterbi(bsrc, bpdf, bw, barc, levels, src_of_arc, final, start,
                  loglikes, acoustic_scale, num_states: int):
    """loglikes [B, T, P] -> (best [B], last [B], arcs_taken [T, B]);
    tree-ELL forward + on-device traceback (full [T, S, B] bp history —
    use the _ckpt variant past bp_hist_limit)."""
    B, T, P = loglikes.shape
    S = num_states
    A = src_of_arc.shape[0]
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [T, P, B]

    score0 = jnp.full((S, B), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[start, :].set(0.0)

    def step(score, ll_t):
        return _tree_max_step(bsrc, bpdf, bw, barc, levels, A, score,
                              ll_t, acoustic_scale)

    final_score, bps = jax.lax.scan(step, score0, ll_tpb)
    total = final_score + final[:, None]
    best = total.max(axis=0)
    last = total.argmax(axis=0).astype(jnp.int32)

    def back_step(state, bp_t):
        arc = jnp.take_along_axis(bp_t, state[None, :], axis=0)[0]
        safe = jnp.clip(arc, 0, A - 1)
        prev = jnp.where(arc < A, jnp.take(src_of_arc, safe), state)
        return prev, arc

    _, arcs_taken = jax.lax.scan(back_step, last, bps, reverse=True)
    return best, last, arcs_taken


@functools.partial(jax.jit, static_argnames=("num_states", "chunk"))
def _tree_viterbi_ckpt(bsrc, bpdf, bw, barc, levels, src_of_arc, final,
                       start, loglikes, acoustic_scale, num_states: int,
                       chunk: int):
    """_tree_viterbi with checkpointed scores (same sqrt(T) remat trade
    as _arc_viterbi_ckpt: no [T, S, B] backpointer table on HBM)."""
    B, T, P = loglikes.shape
    S = num_states
    A = src_of_arc.shape[0]
    nc = T // chunk
    rem = T - nc * chunk
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))
    ll_c = ll_tpb[:nc * chunk].reshape(nc, chunk, P, B)
    ll_rem = ll_tpb[nc * chunk:]

    score0 = jnp.full((S, B), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[start, :].set(0.0)

    def step(score, ll_t):
        return _tree_max_step(bsrc, bpdf, bw, barc, levels, A, score,
                              ll_t, acoustic_scale)

    def fwd_chunk(score, ll_chunk):
        def f(s, ll_t):
            nxt, _ = step(s, ll_t)
            return nxt, None
        end, _ = jax.lax.scan(f, score, ll_chunk)
        return end, score                  # checkpoint chunk-START score

    score_T1, ckpts = jax.lax.scan(fwd_chunk, score0, ll_c)
    if rem:
        final_score, _ = jax.lax.scan(
            lambda s, ll_t: (step(s, ll_t)[0], None), score_T1, ll_rem)
    else:
        final_score = score_T1
    total = final_score + final[:, None]
    best = total.max(axis=0)
    last = total.argmax(axis=0).astype(jnp.int32)

    def back_step(state, bp_t):
        arc = jnp.take_along_axis(bp_t, state[None, :], axis=0)[0]
        safe = jnp.clip(arc, 0, A - 1)
        prev = jnp.where(arc < A, jnp.take(src_of_arc, safe), state)
        return prev, arc

    def remat_back(state, score_c0, ll_chunk):
        _, bps = jax.lax.scan(step, score_c0, ll_chunk)
        return jax.lax.scan(back_step, state, bps, reverse=True)

    state = last
    if rem:
        state, arcs_rem = remat_back(state, score_T1, ll_rem)

    def back_chunk(state, inp):
        score_c0, ll_chunk = inp
        return remat_back(state, score_c0, ll_chunk)

    _, arcs_taken = jax.lax.scan(back_chunk, state, (ckpts, ll_c),
                                 reverse=True)
    arcs_taken = arcs_taken.reshape(nc * chunk, B)
    if rem:
        arcs_taken = jnp.concatenate([arcs_taken, arcs_rem], axis=0)
    return best, last, arcs_taken


def _make_arc_step(src, dst, pdf, weight, acoustic_scale, S: int):
    """The arc-parallel Viterbi frame step shared by the offline scan
    (_arc_viterbi) and the streaming chunk kernel (_arc_viterbi_chunk):
    candidate = score[src] + w + scale*ll[pdf], sorted segment-max into
    destinations, winning-arc backpointer = smallest arc id achieving
    the max."""
    A = src.shape[0]
    arc_ids = jnp.arange(A, dtype=jnp.int32)

    def step(score, ll_t):
        cand = (jnp.take(score, src, axis=0)
                + weight[:, None]
                + acoustic_scale * jnp.take(ll_t, pdf, axis=0))   # [A, B]
        nxt = jax.ops.segment_max(cand, dst, num_segments=S,
                                  indices_are_sorted=True)        # [S, B]
        nxt = jnp.maximum(nxt, NEG_INF)   # segment_max pads with -inf
        win = cand >= jnp.take(nxt, dst, axis=0)
        bp = jax.ops.segment_min(
            jnp.where(win, arc_ids[:, None], jnp.int32(A)), dst,
            num_segments=S, indices_are_sorted=True)              # [S, B]
        return nxt, bp

    return step


@functools.partial(jax.jit, static_argnames=("num_states",))
def _arc_viterbi_chunk(src, dst, pdf, weight, score, loglikes,
                       acoustic_scale, num_states: int):
    """Streaming chunk step: carry `score` [S, B] across calls.

    loglikes [B, C, P] -> (score' [S, B], bps [C, S, B]).  The score
    recursion is identical to _arc_viterbi's, so a stream fed chunk by
    chunk reproduces the offline decode exactly (decode/streaming.py
    owns the host-side backpointer accumulation and traceback)."""
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [C, P, B]
    step = _make_arc_step(src, dst, pdf, weight, acoustic_scale,
                          num_states)
    return jax.lax.scan(step, score, ll_tpb)


@functools.partial(jax.jit, static_argnames=("num_arcs",))
def _tree_viterbi_chunk(bsrc, bpdf, bw, barc, levels, score, loglikes,
                        acoustic_scale, num_arcs: int):
    """Streaming chunk step over the capped tree-ELL layout: carry
    `score` [S, B] across calls, loglikes [B, C, P] -> (score' [S, B],
    bps [C, S, B] winning ArcGraph arc ids).  The frame recursion is
    _tree_max_step — identical to the offline _tree_viterbi — so a
    stream fed chunk by chunk reproduces the offline decode exactly.
    This is what lets the HCLG-scale (>64K-arc) windowed streaming
    decoder reuse the offline kernels (decode/streaming.py
    WindowedStreamingDecoder)."""
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [C, P, B]

    def step(s, ll_t):
        return _tree_max_step(bsrc, bpdf, bw, barc, levels, num_arcs,
                              s, ll_t, acoustic_scale)

    return jax.lax.scan(step, score, ll_tpb)


@functools.partial(jax.jit, static_argnames=("num_states",))
def _arc_viterbi(src, dst, pdf, weight, final, start, loglikes,
                 acoustic_scale, num_states: int):
    """loglikes [B, T, P] -> (best [B], last [B], arcs_taken [T, B]).

    Forward: one lax.scan over frames; score kept state-major [S, B];
    per-arc candidate = score[src] + w + scale*ll[pdf], reduced into
    destinations with a sorted segment-max; the winning ARC id per
    (state, frame) stays on device.  Traceback: a reverse scan walks
    bp[t, state] -> src[arc] so only [T, B] int32 leaves the chip.
    """
    B, T, P = loglikes.shape
    S = num_states
    A = src.shape[0]
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [T, P, B]

    score0 = jnp.full((S, B), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[start, :].set(0.0)
    step = _make_arc_step(src, dst, pdf, weight, acoustic_scale, S)

    final_score, bps = jax.lax.scan(step, score0, ll_tpb)         # [T, S, B]
    total = final_score + final[:, None]
    best = total.max(axis=0)
    last = total.argmax(axis=0).astype(jnp.int32)                 # [B]

    def back_step(state, bp_t):
        arc = jnp.take_along_axis(bp_t, state[None, :], axis=0)[0]  # [B]
        safe = jnp.clip(arc, 0, A - 1)
        prev = jnp.where(arc < A, jnp.take(src, safe), state)
        return prev, arc

    _, arcs_taken = jax.lax.scan(back_step, last, bps, reverse=True)
    return best, last, arcs_taken


def _pick_chunk(T: int, S: int, B: int, limit: int) -> int:
    """Chunk size for the checkpointed decode kernels: ~sqrt(T)
    minimizes max(live block, checkpoint array) = max(chunk, T/chunk) *
    S*B*4 bytes; clamp down if even the live block would exceed the
    limit.  No divisibility requirement — the kernels handle a ragged
    final chunk."""
    chunk = max(1, int(math.isqrt(T)))
    per_frame = S * B * 4
    if chunk * per_frame > limit:
        chunk = max(1, limit // per_frame)
    return min(chunk, T)


@functools.partial(jax.jit, static_argnames=("num_states", "chunk"))
def _arc_viterbi_ckpt(src, dst, pdf, weight, final, start, loglikes,
                      acoustic_scale, num_states: int, chunk: int):
    """_arc_viterbi with CHECKPOINTED scores: the plain kernel keeps the
    full backpointer table [T, S, B] on device (3.2 GB at S=100K, B=16,
    T=500 — the HBM ceiling that capped HCLG batch size).  Here the
    forward saves scores only at chunk boundaries; the traceback
    recomputes each chunk's backpointers ([chunk, S, B] live) while
    walking backwards — the same sqrt(T) rematerialization trade as
    _lattice_masks_ckpt.  A ragged final chunk (T % chunk) is processed
    outside the chunk scans, so any chunk <= T works."""
    B, T, P = loglikes.shape
    S = num_states
    A = src.shape[0]
    nc = T // chunk
    rem = T - nc * chunk
    ll_tpb = jnp.transpose(loglikes, (1, 2, 0))          # [T, P, B]
    ll_c = ll_tpb[:nc * chunk].reshape(nc, chunk, P, B)
    ll_rem = ll_tpb[nc * chunk:]                         # [rem, P, B]

    score0 = jnp.full((S, B), NEG_INF, dtype=jnp.float32)
    score0 = score0.at[start, :].set(0.0)
    arc_ids = jnp.arange(A, dtype=jnp.int32)

    def step(score, ll_t):
        cand = (jnp.take(score, src, axis=0)
                + weight[:, None]
                + acoustic_scale * jnp.take(ll_t, pdf, axis=0))   # [A, B]
        nxt = jax.ops.segment_max(cand, dst, num_segments=S,
                                  indices_are_sorted=True)
        nxt = jnp.maximum(nxt, NEG_INF)
        win = cand >= jnp.take(nxt, dst, axis=0)
        bp = jax.ops.segment_min(
            jnp.where(win, arc_ids[:, None], jnp.int32(A)), dst,
            num_segments=S, indices_are_sorted=True)
        return nxt, bp

    def fwd_chunk(score, ll_chunk):
        def f(s, ll_t):
            nxt, _ = step(s, ll_t)
            return nxt, None
        end, _ = jax.lax.scan(f, score, ll_chunk)
        return end, score                  # checkpoint chunk-START score

    score_T1, ckpts = jax.lax.scan(fwd_chunk, score0, ll_c)
    if rem:
        final_score, _ = jax.lax.scan(
            lambda s, ll_t: (step(s, ll_t)[0], None), score_T1, ll_rem)
    else:
        final_score = score_T1
    total = final_score + final[:, None]
    best = total.max(axis=0)
    last = total.argmax(axis=0).astype(jnp.int32)                 # [B]

    def back_step(state, bp_t):
        arc = jnp.take_along_axis(bp_t, state[None, :], axis=0)[0]
        safe = jnp.clip(arc, 0, A - 1)
        prev = jnp.where(arc < A, jnp.take(src, safe), state)
        return prev, arc

    def remat_back(state, score_c0, ll_chunk):
        _, bps = jax.lax.scan(step, score_c0, ll_chunk)
        return jax.lax.scan(back_step, state, bps, reverse=True)

    state = last
    if rem:
        state, arcs_rem = remat_back(state, score_T1, ll_rem)

    def back_chunk(state, inp):
        score_c0, ll_chunk = inp
        return remat_back(state, score_c0, ll_chunk)

    _, arcs_taken = jax.lax.scan(back_chunk, state, (ckpts, ll_c),
                                 reverse=True)
    arcs_taken = arcs_taken.reshape(nc * chunk, B)
    if rem:
        arcs_taken = jnp.concatenate([arcs_taken, arcs_rem], axis=0)
    return best, last, arcs_taken


class _DataSharding:
    """Batch-axis GSPMD sharding for the device decoders (no-op without
    a mesh).  Graph arrays replicate; [B, ...] inputs shard over the
    data axis; every downstream [.., B] tensor inherits the sharding."""

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            self._rep = NamedSharding(mesh, PartitionSpec())
            self._batch = NamedSharding(
                mesh, PartitionSpec(axis, None, None))
            self._cols = NamedSharding(mesh, PartitionSpec(None, axis))
            self.n = mesh.shape[axis]

    def replicate(self, x):
        x = jnp.asarray(x)
        return x if self.mesh is None else jax.device_put(x, self._rep)

    def shard_batch(self, ll):
        if self.mesh is None:
            return ll
        if ll.shape[0] % self.n:
            raise ValueError(f"batch {ll.shape[0]} not divisible by "
                             f"data-axis size {self.n}")
        return jax.device_put(ll, self._batch)

    def shard_cols(self, x):
        """[.., B] tensor sharded on its LAST axis (the score fronts of
        the streaming decoders)."""
        if self.mesh is None:
            return x
        if x.shape[-1] % self.n:
            raise ValueError(f"batch {x.shape[-1]} not divisible by "
                             f"data-axis size {self.n}")
        return jax.device_put(x, self._cols)


class SparseViterbiDecoder:
    """Exact batched Viterbi over an epsilon-free graph, arc-parallel on
    device with on-device traceback (same results as DenseViterbiDecoder,
    much faster at bench-scale graphs — tools/decodebench.py).

    layout='auto' (default) picks per graph scale: 'segment' below
    ~64K arcs, 'tree' above (the segment kernel's per-frame scatter
    lowering grows with the arc count, while the tree-ELL kernel is
    pure gathers + axis-max).  The 64K switch point was tuned on an
    earlier accelerator and has not been re-derived on the H100.  layout='ell' is the uncapped degree-bucketed
    kernel (exact-parity opt-in; compile-pathological at S=100K);
    layout='tree' forces the capped multi-level kernel;
    layout='segment' forces the scatter kernel.

    `mesh`: decode data-parallel over the mesh's `data_axis` — the graph
    arrays replicate to every device and the batch shards, so inference
    scales over chips exactly like training does (decode is
    embarrassingly parallel over utterances: GSPMD partitions every
    [.., B] tensor in the scans with zero collectives).  B must divide
    by the axis size."""

    # above this many arcs, layout='auto' switches from the segment
    # kernel (scatter lowering ~4 GB/s, dominates at HCLG scale) to the
    # capped tree-ELL kernel
    AUTO_TREE_ARCS = 1 << 16

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 layout: str = "auto", mesh=None, data_axis: str = "data",
                 tree_max_width: int = 128):
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        if layout == "auto":
            layout = ("tree" if len(self.arcs.src) > self.AUTO_TREE_ARCS
                      else "segment")
        self.layout = layout
        # above this, decode_batch switches to the checkpointed-score
        # kernel (no [T, S, B] backpointer table; enables big batches
        # on HCLG-scale graphs)
        self.bp_hist_limit = 1 << 30
        self._shard = _DataSharding(mesh, data_axis)
        a = self.arcs
        self._dev = tuple(self._shard.replicate(np.asarray(v)) for v in
                          (a.src, a.dst, a.pdf, a.weight, a.final))
        if layout == "ell":
            self._ell_dev = jax.tree.map(self._shard.replicate,
                                         EllGraph.from_arcs(
                                             a, "in").device_arrays())
        elif layout == "tree":
            self._tree_dev = jax.tree.map(
                self._shard.replicate,
                TreeEllGraph.from_arcs(
                    a, "in", max_width=tree_max_width).device_arrays())
        # scalars uploaded once: each per-call transfer costs a full
        # dispatch round trip
        self._start_j = self._shard.replicate(np.int32(a.start))
        self._scale_j = self._shard.replicate(np.float32(acoustic_scale))

    def decode_batch(self, loglikes) -> List[dict]:
        """loglikes [B, T, P] -> list of {words, alignment, total_cost}."""
        if len(self.arcs.src) == 0:
            # no emitting arcs: with T >= 1 frames no path exists (the
            # device kernels cannot take() from empty arc arrays)
            return [{"words": [], "alignment": [],
                     "total_cost": -NEG_INF, "final_reached": False}
                    for _ in range(np.shape(loglikes)[0])]
        ll = self._shard.shard_batch(
            jnp.asarray(loglikes, dtype=jnp.float32))
        src, dst, pdf, weight, final = self._dev
        if self.layout == "ell":
            bsrc, bpdf, bw, barc, new_of_old = self._ell_dev
            best, last, arcs_taken = _ell_viterbi(
                bsrc, bpdf, bw, barc, new_of_old, src, final,
                self._start_j, ll, self._scale_j,
                num_states=self.arcs.num_states)
        elif self.layout == "tree":
            bsrc, bpdf, bw, barc, levels = self._tree_dev
            hist = ll.shape[1] * self.arcs.num_states * ll.shape[0] * 4
            if hist > self.bp_hist_limit:
                chunk = _pick_chunk(ll.shape[1], self.arcs.num_states,
                                    ll.shape[0], self.bp_hist_limit)
                best, last, arcs_taken = _tree_viterbi_ckpt(
                    bsrc, bpdf, bw, barc, levels, src, final,
                    self._start_j, ll, self._scale_j,
                    num_states=self.arcs.num_states, chunk=chunk)
            else:
                best, last, arcs_taken = _tree_viterbi(
                    bsrc, bpdf, bw, barc, levels, src, final,
                    self._start_j, ll, self._scale_j,
                    num_states=self.arcs.num_states)
        elif ll.shape[1] * self.arcs.num_states * ll.shape[0] * 4 \
                > self.bp_hist_limit:
            # HCLG scale: the [T, S, B] backpointer table would not fit;
            # checkpoint scores and rematerialize per chunk
            chunk = _pick_chunk(ll.shape[1], self.arcs.num_states,
                                ll.shape[0], self.bp_hist_limit)
            best, last, arcs_taken = _arc_viterbi_ckpt(
                src, dst, pdf, weight, final, self._start_j, ll,
                self._scale_j, num_states=self.arcs.num_states,
                chunk=chunk)
        else:
            best, last, arcs_taken = _arc_viterbi(
                src, dst, pdf, weight, final, self._start_j, ll,
                self._scale_j, num_states=self.arcs.num_states)
        best = np.asarray(best)
        arcs_taken = np.asarray(arcs_taken)                       # [T, B]
        A = len(self.arcs.src)
        B = ll.shape[0]
        # vectorized label lookup for the whole batch (a per-arc Python
        # loop costs more than the device scan at production B*T)
        oks = (best > NEG_INF / 2) & (arcs_taken < A).all(axis=0)
        safe = np.minimum(arcs_taken, A - 1)
        il = self.arcs.ilabel[safe]                               # [T, B]
        ol = self.arcs.olabel[safe]
        results = []
        for b in range(B):
            ok = bool(oks[b])
            words = ol[:, b][ol[:, b] > 0].tolist() if ok else []
            results.append({"words": words,
                            "alignment": il[:, b].tolist() if ok else [],
                            "total_cost": -float(best[b]),
                            "final_reached": ok})
        return results


# ---------------------------------------------------------------------------
# Device lattice generation (exact, beam-pruned)
#
# The retrieved literature (PAPERS.md: "GPU-based WFST Decoder with Exact
# Lattice Generation", "GPU-Accelerated Viterbi Exact Lattice Decoder")
# generates lattices on the accelerator; here the scan-shaped form is two
# min-plus scans + one mask: an arc instance (t, a) belongs to the
# lattice iff
#
#     alpha[t, src] + (graph_cost + scale*acoustic_cost) + beta[t+1, dst]
#         <= best_total + lattice_beam
#
# which is EXACTLY Lattice.prune's keep criterion — so the device path is
# exact (full Viterbi, no token beam) where the host token-passing
# decoder is approximate under tight decode beams.  The device emits
# bit-packed masks ([T, A/8, B] uint8, ~1 bit per arc instance); the
# host assembles Lattice objects that plug into the existing n-best /
# LM-rescoring / oracle-WER machinery unchanged.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_states",))
def _lattice_masks(src, dst, pdf, graph_cost, final_cost, start, loglikes,
                   acoustic_scale, lattice_beam, num_states: int):
    """loglikes [B, T, P] -> (packed keep-masks [T, ceil(A/8), B] uint8,
    best [B]).  All costs min-plus (positive = worse)."""
    B, T, P = loglikes.shape
    S = num_states
    A = src.shape[0]
    INF = jnp.float32(-NEG_INF)
    ac_cost = -jnp.transpose(loglikes, (1, 2, 0))        # [T, P, B] cost

    alpha0 = jnp.full((S, B), INF).at[start, :].set(0.0)

    def arc_costs(ll_t):
        return (graph_cost[:, None]
                + acoustic_scale * jnp.take(ll_t, pdf, axis=0))  # [A, B]

    def fwd(alpha, ll_t):
        cand = jnp.take(alpha, src, axis=0) + arc_costs(ll_t)
        nxt = jnp.minimum(
            -jax.ops.segment_max(-cand, dst, num_segments=S,
                                 indices_are_sorted=True), INF)
        return nxt, alpha

    alpha_T, alpha_hist = jax.lax.scan(fwd, alpha0, ac_cost)
    total = alpha_T + final_cost[:, None]
    best = total.min(axis=0)                              # [B]

    betaT = jnp.broadcast_to(final_cost[:, None], (S, B))

    # no reachable final state => keep NOTHING: with best ~ INF, fp32
    # saturation would otherwise make `tot <= best + beam` true for every
    # arc with one finite endpoint (the host path has the same guard in
    # Lattice.prune via np.isfinite(best))
    thr = jnp.where(best > INF / 2, -INF, best + lattice_beam)    # [B]
    pad = (-A) % 8

    # beta recursion reduces into SOURCE states; arcs are dst-sorted, so
    # use segment_min over the unsorted src ids (correct; the sorted-id
    # fast path only applies to the dst-grouped forward).  The keep-mask
    # is emitted IN this scan: tot = alpha_t[src] + cand, with `cand`
    # already holding arc_cost + beta_{t+1}[dst] — one scan and one set
    # of arc gathers fewer than a separate mask pass, and no [T, S, B]
    # beta history ever hits HBM.
    def bwd_step(beta_next, inp):
        alpha_t, ll_t = inp
        cand = arc_costs(ll_t) + jnp.take(beta_next, dst, axis=0)
        beta = jnp.minimum(
            jax.ops.segment_min(cand, src, num_segments=S), INF)
        tot = jnp.take(alpha_t, src, axis=0) + cand       # [A, B]
        kp = jnp.pad(tot <= thr[None, :], ((0, pad), (0, 0)))
        packed = jnp.packbits(kp.astype(jnp.uint8), axis=0)
        return beta, packed

    _, packed = jax.lax.scan(bwd_step, betaT, (alpha_hist, ac_cost),
                             reverse=True)
    return packed, best


@functools.partial(jax.jit, static_argnames=("num_states", "chunk"))
def _lattice_masks_ckpt(src, dst, pdf, graph_cost, final_cost, start,
                        loglikes, acoustic_scale, lattice_beam,
                        num_states: int, chunk: int):
    """_lattice_masks with CHECKPOINTED alpha: the plain kernel
    materializes alpha_hist [T, S, B] (3.2 TB at S=100K, B=16, T=500 —
    HCLG-scale lattices are impossible that way).  Here the forward
    saves alpha only at chunk boundaries [T/chunk, S, B]; the reverse
    sweep recomputes each chunk's alphas ([chunk, S, B] live) before
    running beta+mask — the classic O(sqrt(T)) rematerialization trade:
    one extra forward pass of compute for a T/chunk memory reduction.
    A ragged final chunk (T % chunk) runs outside the chunk scans."""
    B, T, P = loglikes.shape
    S = num_states
    A = src.shape[0]
    nc = T // chunk
    rem = T - nc * chunk
    ac_all = -jnp.transpose(loglikes, (1, 2, 0))         # [T, P, B]
    INF = jnp.float32(-NEG_INF)
    ac_cost = ac_all[:nc * chunk].reshape(nc, chunk, P, B)
    ac_rem = ac_all[nc * chunk:]                         # [rem, P, B]

    alpha0 = jnp.full((S, B), INF).at[start, :].set(0.0)

    def arc_costs(ll_t):
        return (graph_cost[:, None]
                + acoustic_scale * jnp.take(ll_t, pdf, axis=0))  # [A, B]

    def fwd_frame(alpha, ll_t):
        cand = jnp.take(alpha, src, axis=0) + arc_costs(ll_t)
        nxt = jnp.minimum(
            -jax.ops.segment_max(-cand, dst, num_segments=S,
                                 indices_are_sorted=True), INF)
        return nxt, None

    def fwd_chunk(alpha, ll_c):
        alpha_end, _ = jax.lax.scan(fwd_frame, alpha, ll_c)
        return alpha_end, alpha            # checkpoint = chunk-START alpha

    alpha_T1, alpha_ckpt = jax.lax.scan(fwd_chunk, alpha0, ac_cost)
    if rem:
        alpha_T, _ = jax.lax.scan(fwd_frame, alpha_T1, ac_rem)
    else:
        alpha_T = alpha_T1
    total = alpha_T + final_cost[:, None]
    best = total.min(axis=0)                              # [B]

    betaT = jnp.broadcast_to(final_cost[:, None], (S, B))
    thr = jnp.where(best > INF / 2, -INF, best + lattice_beam)    # [B]
    pad = (-A) % 8

    def fwd_emit(alpha, ll_t):
        nxt, _ = fwd_frame(alpha, ll_t)
        return nxt, alpha                  # alpha BEFORE consuming frame

    def bwd_frame(beta_next, inp):
        alpha_t, ll_t = inp
        cand = arc_costs(ll_t) + jnp.take(beta_next, dst, axis=0)
        beta = jnp.minimum(
            jax.ops.segment_min(cand, src, num_segments=S), INF)
        tot = jnp.take(alpha_t, src, axis=0) + cand       # [A, B]
        kp = jnp.pad(tot <= thr[None, :], ((0, pad), (0, 0)))
        packed = jnp.packbits(kp.astype(jnp.uint8), axis=0)
        return beta, packed

    def remat_bwd(beta_next, alpha_c0, ll_c):
        _, alphas = jax.lax.scan(fwd_emit, alpha_c0, ll_c)  # [chunk, S, B]
        return jax.lax.scan(bwd_frame, beta_next,
                            (alphas, ll_c), reverse=True)

    beta = betaT
    if rem:
        beta, packed_rem = remat_bwd(beta, alpha_T1, ac_rem)

    def bwd_chunk(beta_next, inp):
        alpha_c0, ll_c = inp
        return remat_bwd(beta_next, alpha_c0, ll_c)

    _, packed = jax.lax.scan(bwd_chunk, beta, (alpha_ckpt, ac_cost),
                             reverse=True)
    packed = packed.reshape(nc * chunk, packed.shape[-2], B)
    if rem:
        packed = jnp.concatenate([packed, packed_rem], axis=0)
    return packed, best


@functools.partial(jax.jit, static_argnames=("num_states",))
def _lattice_masks_ell(in_src, in_pdf, in_w, in_perm,
                       out_dst, out_pdf, out_w, out_perm,
                       src, dst, pdf, graph_cost, final_cost, start,
                       loglikes, acoustic_scale, lattice_beam,
                       num_states: int):
    """Scatter-free variant of _lattice_masks: the alpha (by-dst) and
    beta (by-src) min-plus reductions run on ELL degree buckets (gathers
    + axis-min); the keep-mask pass is unchanged.  ELL pads carry
    weight=NEG_INF, i.e. cost +1e30 — they never win a min."""
    B, T, P = loglikes.shape
    S = num_states
    A = src.shape[0]
    INF = jnp.float32(-NEG_INF)
    ac_cost = -jnp.transpose(loglikes, (1, 2, 0))        # [T, P, B]

    alpha0 = jnp.full((S, B), INF).at[start, :].set(0.0)

    def ell_min(vals, ll_t, bstate, bpdf, bw, perm):
        outs = []
        for st_b, pdf_b, w_b in zip(bstate, bpdf, bw):
            sb = st_b.shape + (B,)
            cand = (_ell_gather(vals, st_b.reshape(-1), sb)
                    + (-w_b)[..., None]
                    + acoustic_scale
                    * _ell_gather(ll_t, pdf_b.reshape(-1), sb))
            outs.append(cand.min(axis=1))
        return jnp.minimum(
            jnp.take(jnp.concatenate(outs, axis=0), perm, axis=0), INF)

    def fwd(alpha, ll_t):
        nxt = ell_min(alpha, ll_t, in_src, in_pdf, in_w, in_perm)
        return nxt, alpha

    alpha_T, alpha_hist = jax.lax.scan(fwd, alpha0, ac_cost)
    total = alpha_T + final_cost[:, None]
    best = total.min(axis=0)                              # [B]

    betaT = jnp.broadcast_to(final_cost[:, None], (S, B))
    thr = jnp.where(best > INF / 2, -INF, best + lattice_beam)    # [B]
    pad = (-A) % 8

    def arc_costs(ll_t):
        return (graph_cost[:, None]
                + acoustic_scale * jnp.take(ll_t, pdf, axis=0))   # [A, B]

    # mask emitted inside the beta scan (see _lattice_masks); the ELL
    # reduction gives beta, the mask still reads per-arc endpoints
    def bwd_step(beta_next, inp):
        alpha_t, ll_t = inp
        beta = ell_min(beta_next, ll_t, out_dst, out_pdf, out_w, out_perm)
        tot = (jnp.take(alpha_t, src, axis=0) + arc_costs(ll_t)
               + jnp.take(beta_next, dst, axis=0))        # [A, B]
        kp = jnp.pad(tot <= thr[None, :], ((0, pad), (0, 0)))
        packed = jnp.packbits(kp.astype(jnp.uint8), axis=0)
        return beta, packed

    _, packed = jax.lax.scan(bwd_step, betaT, (alpha_hist, ac_cost),
                             reverse=True)
    return packed, best


@functools.partial(jax.jit, static_argnames=("num_states",))
def _lattice_masks_tree(tin, tout, rstate, final_cost, start, loglikes,
                        acoustic_scale, lattice_beam, num_states: int):
    """Scatter-free lattice masks on the capped tree-ELL layout: alpha
    (by-dst) and beta (by-src) min-plus reductions are multi-level
    gathers + axis-min, and the keep-mask is FUSED into the beta
    reduction's level-1 slots (_tree_min_step_mask) — no per-arc
    gathers at all; masks come back in slot order ([T, ceil(slots/8),
    B] uint8) and the host permutes slot bits to arc ids.  tin/tout:
    (bstate, bpdf, bw, levels); rstate: per level-1 bucket, the owning
    src state of each out-direction row."""
    B, T, P = loglikes.shape
    S = num_states
    INF = jnp.float32(-NEG_INF)
    ac_cost = -jnp.transpose(loglikes, (1, 2, 0))        # [T, P, B]

    alpha0 = jnp.full((S, B), INF).at[start, :].set(0.0)
    in_src, in_pdf, in_w, in_lvls = tin
    out_dst, out_pdf, out_w, out_lvls = tout
    n_slots = sum(t.shape[0] * t.shape[1] for t in out_dst)
    pad = (-n_slots) % 8

    def fwd(alpha, ll_t):
        nxt = _tree_min_step(in_src, in_pdf, in_w, in_lvls, alpha, ll_t,
                             acoustic_scale)
        return nxt, alpha

    alpha_T, alpha_hist = jax.lax.scan(fwd, alpha0, ac_cost)
    total = alpha_T + final_cost[:, None]
    best = total.min(axis=0)                              # [B]

    betaT = jnp.broadcast_to(final_cost[:, None], (S, B))
    thr = jnp.where(best > INF / 2, -INF, best + lattice_beam)    # [B]

    def bwd_step(beta_next, inp):
        alpha_t, ll_t = inp
        beta, keep = _tree_min_step_mask(
            out_dst, out_pdf, out_w, rstate, out_lvls, beta_next,
            alpha_t, ll_t, acoustic_scale, thr)
        kp = jnp.pad(keep, ((0, pad), (0, 0)))
        packed = jnp.packbits(kp.astype(jnp.uint8), axis=0)
        return beta, packed

    _, packed = jax.lax.scan(bwd_step, betaT, (alpha_hist, ac_cost),
                             reverse=True)
    return packed, best


@functools.partial(jax.jit, static_argnames=("num_states", "chunk"))
def _lattice_masks_tree_ckpt(tin, tout, rstate, final_cost, start,
                             loglikes, acoustic_scale, lattice_beam,
                             num_states: int, chunk: int):
    """_lattice_masks_tree with CHECKPOINTED alpha (same sqrt(T)
    rematerialization as _lattice_masks_ckpt) — the HCLG-scale lattice
    path: scatter-free reductions, fused slot-order keep-mask, AND no
    [T, S, B] alpha history."""
    B, T, P = loglikes.shape
    S = num_states
    nc = T // chunk
    rem = T - nc * chunk
    ac_all = -jnp.transpose(loglikes, (1, 2, 0))         # [T, P, B]
    INF = jnp.float32(-NEG_INF)
    ac_cost = ac_all[:nc * chunk].reshape(nc, chunk, P, B)
    ac_rem = ac_all[nc * chunk:]

    alpha0 = jnp.full((S, B), INF).at[start, :].set(0.0)
    in_src, in_pdf, in_w, in_lvls = tin
    out_dst, out_pdf, out_w, out_lvls = tout
    n_slots = sum(t.shape[0] * t.shape[1] for t in out_dst)
    pad = (-n_slots) % 8

    def fwd_frame(alpha, ll_t):
        nxt = _tree_min_step(in_src, in_pdf, in_w, in_lvls, alpha, ll_t,
                             acoustic_scale)
        return nxt, None

    def fwd_chunk(alpha, ll_c):
        alpha_end, _ = jax.lax.scan(fwd_frame, alpha, ll_c)
        return alpha_end, alpha            # checkpoint = chunk-START alpha

    alpha_T1, alpha_ckpt = jax.lax.scan(fwd_chunk, alpha0, ac_cost)
    if rem:
        alpha_T, _ = jax.lax.scan(fwd_frame, alpha_T1, ac_rem)
    else:
        alpha_T = alpha_T1
    total = alpha_T + final_cost[:, None]
    best = total.min(axis=0)

    betaT = jnp.broadcast_to(final_cost[:, None], (S, B))
    thr = jnp.where(best > INF / 2, -INF, best + lattice_beam)

    def fwd_emit(alpha, ll_t):
        nxt, _ = fwd_frame(alpha, ll_t)
        return nxt, alpha                  # alpha BEFORE consuming frame

    def bwd_frame(beta_next, inp):
        alpha_t, ll_t = inp
        beta, keep = _tree_min_step_mask(
            out_dst, out_pdf, out_w, rstate, out_lvls, beta_next,
            alpha_t, ll_t, acoustic_scale, thr)
        kp = jnp.pad(keep, ((0, pad), (0, 0)))
        packed = jnp.packbits(kp.astype(jnp.uint8), axis=0)
        return beta, packed

    def remat_bwd(beta_next, alpha_c0, ll_c):
        _, alphas = jax.lax.scan(fwd_emit, alpha_c0, ll_c)
        return jax.lax.scan(bwd_frame, beta_next,
                            (alphas, ll_c), reverse=True)

    beta = betaT
    if rem:
        beta, packed_rem = remat_bwd(beta, alpha_T1, ac_rem)

    def bwd_chunk(beta_next, inp):
        alpha_c0, ll_c = inp
        return remat_bwd(beta_next, alpha_c0, ll_c)

    _, packed = jax.lax.scan(bwd_chunk, beta, (alpha_ckpt, ac_cost),
                             reverse=True)
    packed = packed.reshape(nc * chunk, packed.shape[-2], B)
    if rem:
        packed = jnp.concatenate([packed, packed_rem], axis=0)
    return packed, best


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_nonzero_bytes(packed, cap: int):
    """Device-side compaction of the packed keep-mask BEFORE transfer:
    kept bits are ~0.1-5% dense at real lattice beams, so shipping
    the full [T, nbytes, B] byte tensor (143 MB at S=100K, B=8, T=300)
    wastes the D2H link on zeros.

    Returns (idx [cap] int32 flat indices into packed.reshape(-1),
    vals [cap] uint8, count [] int32).  count > cap means overflow —
    the caller falls back to the dense transfer (correctness is never
    beam-dependent).  NOTE: XLA materializes the nonzero cumsum as
    int32 over every element AND runs it at element rate, so callers
    must SLAB large masks (an un-slabbed [300, 62500, 64] mask OOMed
    18 GB of HLO temp at B=64); DeviceLatticeDecoder uses the
    group-level _compact_nonzero_groups instead — this element-level
    variant remains for small masks and tests."""
    flat = packed.reshape(-1)
    nz = flat != 0
    count = nz.sum().astype(jnp.int32)
    idx = jnp.nonzero(nz, size=cap, fill_value=0)[0].astype(jnp.int32)
    return idx, flat[idx], count


_COMPACT_GROUP = 32


def _slab_gcap(slab_shape, compact_cap: int,
               group: int = _COMPACT_GROUP) -> int:
    """Per-slab group cap: compact_cap bounds a FULL slab; a partial
    slab (small mask or ragged tail) can never hold more groups than
    its own byte count / group, so the static nonzero/gather size is
    clamped to that.  Shared by decode_batch and profile_latdecode so
    the profiler always times production's exact computation."""
    return min(int(compact_cap),
               -(-int(np.prod(slab_shape)) // group))


@functools.partial(jax.jit, static_argnames=("cap", "group"))
def _compact_nonzero_groups(packed, cap: int, group: int = _COMPACT_GROUP):
    """Two-level mask compaction: element-level jnp.nonzero runs at
    ELEMENT rate, so the expensive pass here is a
    cheap vector reduce: flag nonzero `group`-byte groups (one
    bandwidth-bound max over the mask), run nonzero only over the
    group FLAGS (1/group the elements), then row-gather the flagged
    groups' bytes.  The host extracts the nonzero bytes from the
    shipped dense groups (~group bytes per kept region; kept bytes
    cluster by frame, so real payloads stay near survival-sized).

    Returns (gidx [cap] int32 group indices, gvals [cap, group] uint8,
    count [] int32 nonzero-group count; count > cap = overflow)."""
    flat = packed.reshape(-1)
    n = flat.shape[0]
    padded = ((n + group - 1) // group) * group
    if padded != n:
        flat = jnp.pad(flat, (0, padded - n))
    g = flat.reshape(-1, group)
    nzg = g.max(axis=1) != 0
    count = nzg.sum().astype(jnp.int32)
    gidx = jnp.nonzero(nzg, size=cap, fill_value=0)[0].astype(jnp.int32)
    return gidx, g[gidx], count


class DeviceLatticeDecoder:
    """Exact beam-pruned lattice generation on device for epsilon-free
    graphs; host assembly into decode.lattice.Lattice objects.
    layout='auto' (default) picks 'segment' below ~64K arcs and 'tree'
    (capped multi-level scatter-free reductions) above — same rationale
    as SparseViterbiDecoder; layout='ell' is the uncapped scatter-free
    opt-in.  `mesh`/`data_axis`: batch-shard the decode over a device
    mesh (see SparseViterbiDecoder).

    `transfer='auto'` (default) compacts the packed keep-mask ON DEVICE
    (_compact_nonzero_bytes) and ships only the nonzero mask bytes +
    indices when the mask tensor is large; 'dense' always ships the
    full packed tensor; 'compact' forces compaction.  `compact_cap` is
    the shipped-entry budget (int32 idx + u8 val = 5 bytes/entry);
    overflow falls back to the dense transfer automatically."""

    # compact the mask transfer above this many packed-mask bytes
    AUTO_COMPACT_BYTES = 1 << 22

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 lattice_beam: float = 8.0, layout: str = "auto",
                 mesh=None, data_axis: str = "data",
                 tree_max_width: int = 128, transfer: str = "auto",
                 compact_cap: int = 1 << 22):
        self.graph = graph
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        self.lattice_beam = lattice_beam
        if layout == "auto":
            layout = ("tree" if len(self.arcs.src)
                      > SparseViterbiDecoder.AUTO_TREE_ARCS else "segment")
        self.layout = layout
        assert transfer in ("auto", "dense", "compact"), transfer
        self.transfer = transfer
        self.compact_cap = int(compact_cap)
        # above this, decode_batch switches to the checkpointed-alpha
        # kernel (rematerialized forward; enables HCLG-scale lattices)
        self.alpha_hist_limit = 1 << 30
        self._shard = _DataSharding(mesh, data_axis)
        rep = self._shard.replicate
        a = self.arcs
        self._src = rep(a.src)
        self._dst = rep(a.dst)
        self._pdf = rep(a.pdf)
        self._gcost = rep(-a.weight)                  # back to tropical cost
        fc = np.where(a.final > NEG_INF / 2, -a.final, -NEG_INF)
        self._fcost = rep(fc.astype(np.float32))
        self._start = rep(np.int32(a.start))
        # scalars uploaded once (per-call transfer = one dispatch RTT)
        self._scale_j = rep(np.float32(acoustic_scale))
        self._beam_j = rep(np.float32(lattice_beam))
        if layout == "ell":
            ein = jax.tree.map(rep, EllGraph.from_arcs(a, "in")
                               .device_arrays())
            eout = jax.tree.map(rep, EllGraph.from_arcs(a, "out")
                                .device_arrays())
            # (src, pdf, w, arc, perm); the lattice scans don't need arcs
            self._ell_in = (ein[0], ein[1], ein[2], ein[4])
            self._ell_out = (eout[0], eout[1], eout[2], eout[4])
        elif layout == "tree":
            tig = TreeEllGraph.from_arcs(a, "in", max_width=tree_max_width)
            tog = TreeEllGraph.from_arcs(a, "out", max_width=tree_max_width)
            tin = jax.tree.map(rep, tig.device_arrays())
            tout = jax.tree.map(rep, tog.device_arrays())
            # (bsrc, bpdf, bw, levels); the min scans don't track arcs —
            # the keep-mask is emitted in the OUT tree's slot order and
            # mapped back to arc ids on the host via _slot_arc
            self._tree_in = (tin[0], tin[1], tin[2], tin[4])
            self._tree_out = (tout[0], tout[1], tout[2], tout[4])
            self._tree_rstate = tuple(rep(jnp.asarray(x))
                                      for x in tog.row_state)
            self._slot_arc = np.concatenate(
                [t.reshape(-1) for t in tog.arc])     # pad slots = A

    def decode_batch(self, loglikes) -> List["object"]:
        """loglikes [B, T, P] -> list of Lattice (already beam-pruned)."""
        from kaldi_fp16_tpu.decode.lattice import ArcArrays, Lattice
        if len(self.arcs.src) == 0:
            return [Lattice(num_nodes=1, arcs=[],
                            final_cost=np.array([np.inf]),
                            node_frame=np.zeros(1, np.int64))
                    for _ in range(np.shape(loglikes)[0])]
        ll = self._shard.shard_batch(
            jnp.asarray(loglikes, dtype=jnp.float32))
        B, T, P = ll.shape
        S = self.arcs.num_states
        hist_bytes = T * S * B * 4
        if self.layout == "ell":
            if hist_bytes > self.alpha_hist_limit:
                raise ValueError(
                    f"layout='ell' materializes the full alpha history "
                    f"([T={T}, S={S}, B={B}] = {hist_bytes/2**30:.1f} GiB "
                    f"> alpha_hist_limit {self.alpha_hist_limit/2**30:.1f} "
                    f"GiB); use layout='segment' (routes through the "
                    f"checkpointed-alpha kernel at this scale) or shrink "
                    f"the batch/graph")
            packed, best = _lattice_masks_ell(
                *self._ell_in, *self._ell_out,
                self._src, self._dst, self._pdf, self._gcost, self._fcost,
                self._start, ll, self._scale_j, self._beam_j,
                num_states=self.arcs.num_states)
        elif self.layout == "tree":
            if hist_bytes > self.alpha_hist_limit:
                chunk = _pick_chunk(T, S, B, self.alpha_hist_limit)
                packed, best = _lattice_masks_tree_ckpt(
                    self._tree_in, self._tree_out, self._tree_rstate,
                    self._fcost, self._start, ll, self._scale_j,
                    self._beam_j, num_states=self.arcs.num_states,
                    chunk=chunk)
            else:
                packed, best = _lattice_masks_tree(
                    self._tree_in, self._tree_out, self._tree_rstate,
                    self._fcost, self._start, ll, self._scale_j,
                    self._beam_j, num_states=self.arcs.num_states)
        elif hist_bytes > self.alpha_hist_limit:
            # HCLG scale: alpha_hist [T, S, B] would not fit (3.2 TB at
            # S=100K/B=16/T=500); checkpointed-alpha kernel instead
            chunk = _pick_chunk(T, S, B, self.alpha_hist_limit)
            packed, best = _lattice_masks_ckpt(
                self._src, self._dst, self._pdf, self._gcost, self._fcost,
                self._start, ll, self._scale_j, self._beam_j,
                num_states=self.arcs.num_states, chunk=chunk)
        else:
            packed, best = _lattice_masks(
                self._src, self._dst, self._pdf, self._gcost, self._fcost,
                self._start, ll, self._scale_j, self._beam_j,
                num_states=self.arcs.num_states)
        nbytes_row = int(packed.shape[1])
        total_mask_bytes = int(np.prod(packed.shape))
        use_compact = (self.transfer == "compact"
                       or (self.transfer == "auto"
                           and total_mask_bytes > self.AUTO_COMPACT_BYTES))
        sparse_by_b = None
        if use_compact:
            # slab over frames to bound the group-flag temp, then
            # two-level compaction per slab (see _compact_nonzero_groups
            # — element-level nonzero runs at ELEMENT rate)
            slab_elems = 1 << 28
            slab_t = max(1, slab_elems // max(nbytes_row * B, 1))
            G = _COMPACT_GROUP
            idx_parts, val_parts = [], []
            ok = True
            # group cap: kept bytes cluster, but worst-case one group
            # per kept byte; _slab_gcap clamps the static nonzero/gather
            # size to the slab's real group count (an unclamped cap
            # gathers cap*G bytes of temp per slab however small the
            # mask)
            for t0 in range(0, int(packed.shape[0]), slab_t):
                slab = packed[t0:t0 + slab_t]
                gcap = _slab_gcap(slab.shape, self.compact_cap)
                gidx, gvals, count = _compact_nonzero_groups(
                    slab, cap=gcap)
                n = int(jax.device_get(count))
                if n > gcap:
                    ok = False      # overflow: dense fallback below
                    break
                # slice on DEVICE first so the D2H ships only live
                # groups (group + 4 bytes each), not the cap
                k = max(n, 1)
                gidx_h = np.asarray(gidx[:k])[:n].astype(np.int64)
                gvals_h = np.asarray(gvals[:k])[:n]
                # expand groups -> nonzero byte positions on the host
                pos = (gidx_h[:, None] * G
                       + np.arange(G, dtype=np.int64)[None, :]).ravel()
                vals_flat = gvals_h.ravel()
                nzb = vals_flat != 0
                slab_size = int(np.prod(slab.shape))
                keep = nzb & (pos < slab_size)     # drop group padding
                idx_parts.append(pos[keep] + t0 * nbytes_row * B)
                val_parts.append(vals_flat[keep])
            if ok:
                idx_h = (np.concatenate(idx_parts)
                         if idx_parts else np.zeros(0, np.int64))
                vals_h = (np.concatenate(val_parts)
                          if val_parts else np.zeros(0, np.uint8))
                bcol = idx_h % B
                rem = idx_h // B
                byts_all = rem % nbytes_row
                ts8_all = rem // nbytes_row
                sparse_by_b = [
                    (ts8_all[m], byts_all[m], vals_h[m])
                    for m in (bcol == b for b in range(B))]
        if sparse_by_b is None:
            packed = np.asarray(packed)               # [T, bits/8, B]
        best = np.asarray(best)
        a = self.arcs
        A = len(a.src)
        S = self.arcs.num_states
        nbits = len(self._slot_arc) if self.layout == "tree" else A
        # acoustic costs: with the compact transfer, gather ONLY the
        # kept arcs' loglikes on device (one fancy-indexed gather, ~4
        # bytes per kept arc) instead of downloading the whole
        # [B, T, P] tensor — 157 MB at B=64/T=300/P=2048 was the next
        # transfer wall after the mask compaction
        lls = None if sparse_by_b is not None else np.asarray(ll)
        pending = []          # (ts, ais, uniq, inv, ...) per b
        out = []
        for b in range(B):
            # vectorized assembly: node key = frame*S + state; np.unique
            # keys ascending, and in an exact lattice every frame-0
            # source is the start state (alpha[0] is finite only there),
            # so node 0 is always (0, start) as Lattice requires.
            # Kept bits are sparse (~0.1-5% of slots at real beams), so
            # unpack only the NONZERO BYTES: a dense
            # unpackbits+nonzero over [T, nbits] costs ~1.5 s/utterance
            # at HCLG scale (477K slots x 300 frames) and dominated the
            # whole decode at B=64; this path is ~byte-density bound.
            # With the compact transfer the nonzero bytes arrive
            # pre-extracted from the device.
            if sparse_by_b is not None:
                ts8, byts, nzvals = sparse_by_b[b]
            else:
                pb = packed[:, :, b]                    # [T, nbytes]
                ts8, byts = np.nonzero(pb)
                nzvals = pb[ts8, byts]
            bits = np.unpackbits(nzvals)                # MSB-first
            slots = (byts[:, None] * 8
                     + np.arange(8, dtype=byts.dtype)[None, :]).ravel()
            sel = (bits > 0) & (slots < nbits)
            ts = np.repeat(ts8, 8)[sel]
            ais = slots[sel]
            if self.layout == "tree":
                # slot order -> arc ids; pad slots can't fire (their
                # NEG_INF weight makes the kept total +inf) but guard
                # anyway, then restore the canonical (t, arc) order the
                # per-arc kernels emit
                ais = self._slot_arc[ais]
                live = ais < A
                ts, ais = ts[live], ais[live]
                o = np.lexsort((ais, ts))
                ts, ais = ts[o], ais[o]
            src_keys = ts.astype(np.int64) * S + a.src[ais]
            dst_keys = (ts.astype(np.int64) + 1) * S + a.dst[ais]
            start_key = np.asarray([0 * S + a.start], np.int64)
            uniq, inv = np.unique(
                np.concatenate([start_key, src_keys, dst_keys]),
                return_inverse=True)
            pending.append((ts, ais, uniq, inv))

        if lls is None:
            # one batched device gather for every kept arc of every b
            counts = [len(p[0]) for p in pending]
            bb = np.repeat(np.arange(B, dtype=np.int32),
                           np.asarray(counts, np.int64))
            tt = (np.concatenate([p[0] for p in pending])
                  if pending else np.zeros(0, np.int64)).astype(np.int32)
            pp = a.pdf[np.concatenate([p[1] for p in pending])
                       if pending else np.zeros(0, np.int64)]
            ac_all = np.asarray(ll[jnp.asarray(bb), jnp.asarray(tt),
                                   jnp.asarray(pp)]) if len(bb) else \
                np.zeros(0, np.float32)
            splits = np.cumsum(counts)[:-1]
            ac_by_b = np.split(ac_all, splits)
        else:
            ac_by_b = [lls[b, p[0], a.pdf[p[1]]]
                       for b, p in enumerate(pending)]

        for b, (ts, ais, uniq, inv) in enumerate(pending):
            n = len(uniq)
            k = len(ts)
            src_ids = inv[1:1 + k]
            dst_ids = inv[1 + k:]
            frames = (uniq // S).astype(np.int64)
            arcs = ArcArrays(src_ids, dst_ids, a.ilabel[ais], a.olabel[ais],
                             (-a.weight[ais]).astype(np.float64),
                             (-ac_by_b[b]).astype(np.float64))
            final = np.full(n, np.inf)
            at_T = frames == T
            if at_T.any():
                fc = self.graph.final_cost[uniq[at_T] - T * S]
                final[at_T] = fc
            out.append(Lattice(num_nodes=n, arcs=arcs, final_cost=final,
                               node_frame=frames))
        return out
