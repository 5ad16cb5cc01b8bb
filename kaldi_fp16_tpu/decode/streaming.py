"""Streaming (online) inference: chunked acoustic forward + incremental
Viterbi with bounded latency.

The reference has no serving/online path at all (SURVEY §6: no decoder;
training egs arrive pre-chunked with context baked in).  This module is
the equivalent of Kaldi's online2 nnet3 pipeline, built for
static shapes and one-compile steady state:

* **StreamingEncoder** — the acoustic model consumes fixed-size input
  chunks (`subsample * chunk_out` frames) and emits `chunk_out`
  posterior frames per step once warm.  Each step runs the network on a
  fixed window of `left_ctx + chunk_in + right_ctx` frames (one XLA
  compile, reused for the whole stream) and keeps the central outputs.
  The edge convention matches Kaldi online2: the stream is padded with
  replicated first/last frames, so streaming output equals the OFFLINE
  forward of that edge-padded utterance exactly — and is chunk-size
  invariant (the serving-critical property; tests/test_streaming.py
  pins both).  The window context comes from `Model.time_context()`, a
  per-layer receptive-field sum (an over-estimate costs overlap
  compute, never correctness).  Inherent algorithmic latency =
  right_ctx input frames, rounded up to whole chunks.

* **StreamingDecoder** — incremental Viterbi over an epsilon-free
  DecodingGraph: the [S, B] score front carries across chunks through
  the SAME frame recursion as the offline SparseViterbiDecoder
  (tpu_viterbi._make_arc_step), so `finalize()` reproduces
  `decode_batch()` on the concatenated log-likes EXACTLY (words,
  alignment, costs, tie-breaks).  Per-chunk backpointer tables
  ([C, S, B] int32) stay DEVICE-resident and tracebacks run on device
  chunk by chunk, so only [C, B] int32 ever crosses to the host, not
  the backpointer table itself.  `partial()`
  gives the current best hypothesis without final weights at any
  point.  Device memory grows T*S*B*4 bytes per stream (196 MB for a
  2-minute utterance at S=2048, B=8); HCLG-scale streams should use
  windowed commits — documented future work, docs/SERVING.md.

* **StreamingPipeline** — features in, hypotheses out; hides the
  encoder warmup lag from the decoder.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_fp16_tpu.decode.tpu_viterbi import (
    NEG_INF, ArcGraph, TreeEllGraph, _arc_viterbi_chunk,
    _tree_viterbi_chunk,
)


# ---------------------------------------------------------------------------
# acoustic encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EncoderState:
    buf: Optional[jnp.ndarray]      # [B, Wbuf, D] rolling padded window
    ivectors: Optional[jnp.ndarray]
    fed: int                        # chunks fed
    emitted: int                    # chunks emitted


class StreamingEncoder:
    """Chunked acoustic-model forward with context carry (see module
    docstring).  Stateless apply over an explicit EncoderState."""

    def __init__(self, model, params, state, chunk_out: int = 16,
                 subsample: int = 3, context=None,
                 compute_dtype=jnp.bfloat16, output: Optional[str] = None):
        from kaldi_fp16_tpu.models.network import forward
        self.model = model
        self.chunk_out = int(chunk_out)
        self.subsample = int(subsample)
        self.cin = self.subsample * self.chunk_out
        ctx_l, ctx_r = context if context is not None \
            else model.time_context()
        self.ctx_l, self.ctx_r = int(ctx_l), int(ctx_r)
        self.W = self.ctx_l + self.cin + self.ctx_r
        self.lag = -(-self.ctx_r // self.cin)            # chunks of latency
        self.Wbuf = self.ctx_l + (self.lag + 1) * self.cin
        out_name = output or model.chain_output().name

        def _fwd(p, s, window, iv):
            outs, _ = forward(model, p, s, window, iv, train=False,
                              compute_dtype=compute_dtype)
            y = outs[out_name]                           # [B, W, P]
            lo = self.ctx_l
            hi = lo + (self.chunk_out - 1) * self.subsample + 1
            return y[:, lo:hi:self.subsample]            # [B, C, P]

        self._fwd = jax.jit(lambda window, iv: _fwd(params, state,
                                                    window, iv))
        self._shift = jax.jit(
            lambda buf, x: jnp.concatenate([buf[:, x.shape[1]:], x], 1))

    def init(self, ivectors=None) -> EncoderState:
        return EncoderState(buf=None, ivectors=ivectors, fed=0, emitted=0)

    def feed(self, st: EncoderState, x) -> tuple:
        """x [B, chunk_in, D] -> (state', posteriors [B, k*chunk_out, P])
        with k == 0 during warmup (the first `lag` feeds) and 1 after."""
        x = jnp.asarray(x)
        assert x.shape[1] == self.cin, \
            f"fixed chunk size {self.cin} required, got {x.shape[1]}"
        if st.buf is None:
            pad = jnp.repeat(x[:, :1], self.Wbuf - self.cin, axis=1)
            buf = jnp.concatenate([pad, x], axis=1)
        else:
            buf = self._shift(st.buf, x)
        fed = st.fed + 1
        if fed <= self.lag:                              # warming up
            return replace(st, buf=buf, fed=fed), \
                jnp.zeros((x.shape[0], 0, 1), jnp.float32)
        posts = self._fwd(buf[:, :self.W], st.ivectors)
        return (replace(st, buf=buf, fed=fed, emitted=st.emitted + 1),
                posts)

    def flush(self, st: EncoderState) -> tuple:
        """Emit the pending `lag` chunks by feeding last-frame padding."""
        if st.buf is None:
            return st, jnp.zeros((0, 0, 1), jnp.float32)
        outs = []
        for _ in range(self.lag):
            st, p = self.feed(st, jnp.repeat(st.buf[:, -1:], self.cin,
                                             axis=1))
            if p.shape[1]:
                outs.append(p)
        cat = (jnp.concatenate(outs, axis=1) if outs
               else jnp.zeros((st.buf.shape[0], 0, 1), jnp.float32))
        return st, cat

    def offline_reference(self, params, state, x_full, ivectors=None,
                          compute_dtype=jnp.bfloat16,
                          output: Optional[str] = None):
        """The contract oracle: offline forward of the edge-padded
        utterance, outputs at stride `subsample` from offset ctx_l.
        x_full [B, T, D] with T a multiple of chunk_in."""
        from kaldi_fp16_tpu.models.network import forward
        out_name = output or self.model.chain_output().name
        pad_l = jnp.repeat(x_full[:, :1], self.ctx_l, axis=1)
        pad_r = jnp.repeat(x_full[:, -1:], self.lag * self.cin, axis=1)
        padded = jnp.concatenate([pad_l, x_full, pad_r], axis=1)
        outs, _ = forward(self.model, params, state, padded, ivectors,
                          train=False, compute_dtype=compute_dtype)
        y = outs[out_name]
        n_out = x_full.shape[1] // self.subsample
        lo = self.ctx_l
        hi = lo + (n_out - 1) * self.subsample + 1
        return y[:, lo:hi:self.subsample]


# ---------------------------------------------------------------------------
# incremental Viterbi
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecoderState:
    score: jnp.ndarray              # [S, B]
    bps: tuple                      # DEVICE int32 [C, S, B] per chunk
    frames: int


def _make_tb_chunk(src, A: int):
    """One chunk of device traceback: bps [C, S, B], state [B] ->
    (state at chunk start [B], arcs taken [C, B]).  Identical to the
    offline decoders' reverse walk, so tie-breaks match decode_batch.
    BOTH streaming decoders build theirs here — a divergence between
    their walks would silently break the offline-parity contracts."""
    @jax.jit
    def tb_chunk(bps, state):
        def back(st, bp_t):
            arc = jnp.take_along_axis(bp_t, st[None, :], axis=0)[0]
            safe = jnp.clip(arc, 0, A - 1)
            prev = jnp.where(arc < A, jnp.take(src, safe), st)
            return prev, arc
        return jax.lax.scan(back, state, bps, reverse=True)
    return tb_chunk


def _hyps_from_arcs(arcs, best, arcs_taken) -> List[dict]:
    """Arc-id path [T, B] + final scores [B] -> hypothesis dicts;
    identical post-processing to SparseViterbiDecoder.decode_batch,
    shared by both streaming decoders."""
    A = len(arcs.src)
    oks = (best > NEG_INF / 2) & (arcs_taken < A).all(axis=0)
    safe = np.minimum(arcs_taken, A - 1)
    il = arcs.ilabel[safe]
    ol = arcs.olabel[safe]
    results = []
    for b in range(best.shape[0]):
        ok = bool(oks[b])
        results.append({"words": ol[:, b][ol[:, b] > 0].tolist()
                        if ok else [],
                        "alignment": il[:, b].tolist() if ok else [],
                        "total_cost": -float(best[b]),
                        "final_reached": ok})
    return results


class StreamingDecoder:
    """Incremental exact Viterbi (see module docstring)."""

    def __init__(self, graph, acoustic_scale: float = 1.0):
        self.arcs = ArcGraph.from_graph(graph)
        a = self.arcs
        self._dev = tuple(jnp.asarray(v) for v in
                          (a.src, a.dst, a.pdf, a.weight))
        self._final = np.asarray(a.final)
        self._scale = jnp.float32(acoustic_scale)
        self._tb_chunk = _make_tb_chunk(self._dev[0], len(a.src))

    def init(self, batch: int) -> DecoderState:
        S = self.arcs.num_states
        score = jnp.full((S, batch), NEG_INF, jnp.float32)
        score = score.at[self.arcs.start, :].set(0.0)
        return DecoderState(score=score, bps=(), frames=0)

    def feed(self, st: DecoderState, loglikes) -> DecoderState:
        """loglikes [B, C, P]; C may vary per call (one compile per
        distinct C)."""
        ll = jnp.asarray(loglikes, jnp.float32)
        src, dst, pdf, weight = self._dev
        score, bps = _arc_viterbi_chunk(src, dst, pdf, weight, st.score,
                                        ll, self._scale,
                                        num_states=self.arcs.num_states)
        return DecoderState(score=score,
                            bps=st.bps + (bps,),
                            frames=st.frames + ll.shape[1])

    # -- device traceback (chunk-wise; only [C, B] ints reach the host) -------

    def _traceback(self, st: DecoderState, last: np.ndarray) -> np.ndarray:
        state = jnp.asarray(last)
        out = []
        for bps in reversed(st.bps):
            state, arcs = self._tb_chunk(bps, state)
            out.append(np.asarray(arcs))
        return (np.concatenate(out[::-1], axis=0) if out
                else np.zeros((0, len(last)), np.int32))

    def _results(self, best, arcs_taken) -> List[dict]:
        return _hyps_from_arcs(self.arcs, best, arcs_taken)

    def partial(self, st: DecoderState) -> List[dict]:
        """Best hypothesis so far, ignoring final weights (results carry
        final_reached=False semantics of an unfinished stream)."""
        if st.frames == 0:
            return []
        score = np.asarray(st.score)
        last = score.argmax(axis=0).astype(np.int32)
        best = score.max(axis=0)
        arcs = self._traceback(st, last)
        res = self._results(best, arcs)
        for r in res:
            r["final_reached"] = False
        return res

    def finalize(self, st: DecoderState) -> List[dict]:
        """Apply final weights and trace back — equals the offline
        SparseViterbiDecoder.decode_batch on the concatenated frames."""
        score = np.asarray(st.score)
        total = score + self._final[:, None]
        best = total.max(axis=0)
        last = total.argmax(axis=0).astype(np.int32)
        arcs = self._traceback(st, last)
        return self._results(best, arcs)


# ---------------------------------------------------------------------------
# HCLG-scale streaming: windowed commits
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowedDecoderState:
    score: jnp.ndarray          # [S, B] carried Viterbi front
    bps: tuple                  # DEVICE int32 [C_i, S, B] window chunks
    frames: int                 # total frames fed
    committed: tuple            # HOST np int32 [F_j, B] locked arc ids

    @property
    def window_frames(self) -> int:
        return sum(int(b.shape[0]) for b in self.bps)

    @property
    def committed_frames(self) -> int:
        return sum(int(c.shape[0]) for c in self.committed)


class WindowedStreamingDecoder:
    """Streaming Viterbi for HCLG-scale graphs with BOUNDED device
    memory: a sliding `window`-frame backpointer buffer with traceback-
    delay commits (StreamingDecoder grows T*S*B*4
    bytes with stream length — 3-26 GB at S=100K serving shapes).

    Mechanics per feed of a C-frame loglike chunk:
      1. the frame recursion runs on device through the SAME kernels as
         the offline SparseViterbiDecoder — `_arc_viterbi_chunk` below
         64K arcs, the capped tree-ELL `_tree_viterbi_chunk` above
         (the layout that decodes S=100K/390K arcs offline) — appending
         [C, S, B] winning-arc
         tables to the window;
      2. while the window exceeds `window` frames, the decoder traces
         back from the CURRENT best state over the buffered chunks
         (device walk, only [C, B] int32 per chunk reaches the host)
         and COMMITS the arcs of the oldest chunk(s), dropping their
         backpointer tables.

    Exactness contract (delay-adjusted, pinned by
    tests/test_streaming.py): frames committed at delay >= `window` are
    locked from the best path at commit time.  finalize() equals the
    offline decode_batch EXACTLY whenever every commit-time best path
    agrees with the final best path over the committed prefix — the
    standard online-decoding traceback-delay guarantee (Kaldi online2's
    partial traceback; beams that have converged by `window` frames
    back never differ).  Under pathological late evidence the committed
    prefix may differ from offline; the tail (last <= window frames) is
    always exact.

    Device memory: score [S, B] + at most (window + C) backpointer
    frames of [S, B] int32 — INDEPENDENT of stream length (e.g. 165 MB
    at S=100K, B=4, window=96+32, vs 4.8 GB/minute unbounded)."""

    AUTO_TREE_ARCS = 1 << 16

    def __init__(self, graph, acoustic_scale: float = 1.0,
                 window: int = 96, layout: str = "auto",
                 tree_max_width: int = 128, mesh=None,
                 data_axis: str = "data"):
        from kaldi_fp16_tpu.decode.tpu_viterbi import _DataSharding
        self.arcs = ArcGraph.from_graph(graph)
        a = self.arcs
        A = len(a.src)
        if layout == "auto":
            layout = "tree" if A > self.AUTO_TREE_ARCS else "arc"
        self.layout = layout
        self.window = int(window)
        # mesh: batch-shard the streams over the data axis — the graph
        # replicates, every [.., B] tensor (score front, backpointer
        # window, traceback walks) shards, zero collectives, same
        # contract as the offline decoders' mesh= option
        self._shard = _DataSharding(mesh, data_axis)
        rep = self._shard.replicate
        self._scale = rep(np.float32(acoustic_scale))
        self._final = np.asarray(a.final)
        self._src_j = rep(a.src)
        self._A = A
        if layout == "tree":
            self._tree_dev = jax.tree.map(
                rep,
                TreeEllGraph.from_arcs(
                    a, "in", max_width=tree_max_width).device_arrays())
        else:
            self._dev = tuple(rep(v) for v in
                              (a.src, a.dst, a.pdf, a.weight))

        self._tb_chunk = _make_tb_chunk(self._src_j, A)

    def init(self, batch: int) -> WindowedDecoderState:
        S = self.arcs.num_states
        score = jnp.full((S, batch), NEG_INF, jnp.float32)
        score = score.at[self.arcs.start, :].set(0.0)
        return WindowedDecoderState(score=self._shard.shard_cols(score),
                                    bps=(), frames=0, committed=())

    def _fwd_chunk(self, score, ll):
        if self.layout == "tree":
            bsrc, bpdf, bw, barc, levels = self._tree_dev
            return _tree_viterbi_chunk(bsrc, bpdf, bw, barc, levels,
                                       score, ll, self._scale,
                                       num_arcs=self._A)
        src, dst, pdf, weight = self._dev
        return _arc_viterbi_chunk(src, dst, pdf, weight, score, ll,
                                  self._scale,
                                  num_states=self.arcs.num_states)

    def _window_traceback(self, st: WindowedDecoderState,
                          last) -> List[np.ndarray]:
        """Device traceback over the buffered window from `last` [B];
        returns per-chunk host arc arrays in time order.  The walk
        dispatches per chunk but transfers ONCE: a per-chunk
        np.asarray would cost one blocking D2H round trip per chunk per
        feed."""
        state = jnp.asarray(last)
        dev = []
        for bps in reversed(st.bps):
            state, arcs = self._tb_chunk(bps, state)
            dev.append(arcs)
        return jax.device_get(dev)[::-1]

    def feed(self, st: WindowedDecoderState,
             loglikes) -> WindowedDecoderState:
        """loglikes [B, C, P].  Runs the recursion, then commits any
        frames older than `window` via traceback from the current best
        state."""
        ll = self._shard.shard_batch(jnp.asarray(loglikes, jnp.float32))
        score, bps_new = self._fwd_chunk(st.score, ll)
        bps = st.bps + (bps_new,)
        frames = st.frames + int(ll.shape[1])
        committed = st.committed
        buffered = sum(int(b.shape[0]) for b in bps)
        if buffered > self.window:
            # how many of the oldest chunks have fully left the window
            # (every commit happens at traceback delay >= window)?
            # n_drop depends only on host-known chunk sizes — compute it
            # FIRST so a feed that commits nothing (window not aligned
            # to the chunk size) skips the device walk + D2H entirely
            sizes = [int(b.shape[0]) for b in bps]
            n_drop = 0
            while (n_drop < len(sizes)
                   and buffered - sum(sizes[:n_drop + 1]) >= self.window):
                n_drop += 1
            if n_drop:
                # one traceback commits every dropped chunk: the device
                # walk must thread state through ALL buffered chunks to
                # reach the oldest, but only the committed chunks' arcs
                # ([C, B] each) are shipped to the host
                state = jnp.argmax(score, axis=0).astype(jnp.int32)
                dev = []
                for bp in reversed(bps):
                    state, arcs = self._tb_chunk(bp, state)
                    dev.append(arcs)
                committed = committed + tuple(
                    jax.device_get(dev[::-1][:n_drop]))
                bps = bps[n_drop:]
        return WindowedDecoderState(score=score, bps=bps, frames=frames,
                                    committed=committed)

    def _assemble(self, best, committed, tail_arcs) -> List[dict]:
        arcs_all = ([c for c in committed] + tail_arcs)
        arcs_taken = (np.concatenate(arcs_all, axis=0) if arcs_all
                      else np.zeros((0, len(best)), np.int32))
        return _hyps_from_arcs(self.arcs, best, arcs_taken)

    def partial(self, st: WindowedDecoderState) -> List[dict]:
        """Committed prefix + current-window best continuation, final
        weights ignored."""
        if st.frames == 0:
            return []
        score = np.asarray(st.score)
        last = score.argmax(axis=0).astype(np.int32)
        tail = self._window_traceback(st, last)
        res = self._assemble(score.max(axis=0), st.committed, tail)
        for r in res:
            r["final_reached"] = False
        return res

    def finalize(self, st: WindowedDecoderState) -> List[dict]:
        """Final-weighted traceback of the window appended to the
        committed prefix."""
        score = np.asarray(st.score)
        total = score + self._final[:, None]
        best = total.max(axis=0)
        last = total.argmax(axis=0).astype(np.int32)
        tail = self._window_traceback(st, last)
        return self._assemble(best, st.committed, tail)


# ---------------------------------------------------------------------------
# end-to-end pipeline
# ---------------------------------------------------------------------------

class StreamingPipeline:
    """Features in, hypotheses out; hides the encoder warmup lag."""

    def __init__(self, encoder: StreamingEncoder,
                 decoder: StreamingDecoder):
        self.enc = encoder
        self.dec = decoder

    def init(self, batch: int, ivectors=None):
        return (self.enc.init(ivectors), self.dec.init(batch))

    def feed(self, st, features):
        enc_st, dec_st = st
        enc_st, posts = self.enc.feed(enc_st, features)
        if posts.shape[1]:
            dec_st = self.dec.feed(dec_st, posts)
        return (enc_st, dec_st)

    def partial(self, st) -> List[dict]:
        return self.dec.partial(st[1])

    def finalize(self, st) -> List[dict]:
        enc_st, dec_st = st
        enc_st, posts = self.enc.flush(enc_st)
        if posts.shape[1]:
            dec_st = self.dec.feed(dec_st, posts)
        return self.dec.finalize(dec_st)
