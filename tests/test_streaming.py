"""Streaming inference tests: encoder chunk invariance + padded-offline
equality, incremental-Viterbi == offline decode, pipeline end-to-end."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kaldi_fp16_tpu.decode.graph import DecodingGraph  # noqa: E402
from kaldi_fp16_tpu.decode.streaming import (  # noqa: E402
    StreamingDecoder, StreamingEncoder, StreamingPipeline,
)
from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder  # noqa
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState  # noqa: E402
from kaldi_fp16_tpu.models.model import build_model_from_string  # noqa
from kaldi_fp16_tpu.models.network import Network  # noqa: E402

XCONFIG = """\
input name=input dim=8
linear-component name=linear1 dim=16
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=16 bottleneck-dim=8 time-stride=3 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=16 bottleneck-dim=8 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal input=tdnnf2 small-dim=8 big-dim=16
output-layer name=output dim=6 include-log-softmax=false
"""


@pytest.fixture(scope="module")
def net():
    model = build_model_from_string(XCONFIG)
    n = Network(model)
    params, state = n.init(jax.random.PRNGKey(0))
    return model, params, state


def random_graph(num_pdfs=6, num_states=5, seed=0):
    """Small cyclic decoding graph with word labels."""
    rng = np.random.default_rng(seed)
    states = [FstState(final=(0.5 if s >= num_states - 2 else np.inf))
              for s in range(num_states)]
    for s in range(num_states):
        for _ in range(3):
            states[s].arcs.append(FstArc(
                int(rng.integers(1, num_pdfs + 1)),
                float(rng.uniform(0.1, 1.0)),
                int(rng.integers(0, num_states)),
                olabel=int(rng.integers(0, 4))))
    return DecodingGraph.from_fst(Fst(start=0, states=states))


class TestModelContext:
    def test_time_context(self):
        model = build_model_from_string(XCONFIG)
        left, right = model.time_context()
        assert left == right == 6      # two tdnnf at stride 3

    def test_flagship_context(self):
        model = __import__("kaldi_fp16_tpu.models.model",
                           fromlist=["build_model"]).build_model(
            "configs/cnn_tdnn.xconfig")
        left, right = model.time_context()
        assert left > 10 and right > 10


class TestStreamingEncoder:
    def _run(self, net, chunk_out, T_out=12, B=2, dtype=jnp.float32):
        model, params, state = net
        rng = np.random.default_rng(1)
        enc = StreamingEncoder(model, params, state, chunk_out=chunk_out,
                               compute_dtype=dtype)
        T_in = T_out * enc.subsample
        x = jnp.asarray(rng.normal(size=(B, T_in, 8)).astype(np.float32))
        st = enc.init()
        outs = []
        for i in range(T_in // enc.cin):
            st, p = enc.feed(st, x[:, i * enc.cin:(i + 1) * enc.cin])
            if p.shape[1]:
                outs.append(np.asarray(p))
        st, p = enc.flush(st)
        if p.shape[1]:
            outs.append(np.asarray(p))
        got = np.concatenate(outs, axis=1)
        assert got.shape[1] == T_out
        ref = np.asarray(enc.offline_reference(params, state, x,
                                               compute_dtype=dtype))
        return got, ref

    def test_matches_padded_offline(self, net):
        got, ref = self._run(net, chunk_out=4)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)

    def test_chunk_size_invariance(self, net):
        got2, ref = self._run(net, chunk_out=2)
        got6, _ = self._run(net, chunk_out=6)
        np.testing.assert_allclose(got2, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got6, ref, rtol=2e-5, atol=2e-5)

    def test_bf16_compute_close(self, net):
        got, ref = self._run(net, chunk_out=4, dtype=jnp.bfloat16)
        np.testing.assert_allclose(got, ref, rtol=0.1, atol=0.1)


class TestStreamingDecoder:
    def _loglikes(self, B=3, T=24, P=6, seed=2):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(B, T, P)).astype(np.float32)

    @pytest.mark.parametrize("chunks", [[24], [8, 8, 8], [5, 7, 12]])
    def test_matches_offline(self, chunks):
        g = random_graph()
        ll = self._loglikes()
        offline = SparseViterbiDecoder(g, acoustic_scale=0.7,
                                       layout="segment").decode_batch(ll)
        dec = StreamingDecoder(g, acoustic_scale=0.7)
        st = dec.init(ll.shape[0])
        t0 = 0
        for c in chunks:
            st = dec.feed(st, ll[:, t0:t0 + c])
            t0 += c
        got = dec.finalize(st)
        for a, b in zip(got, offline):
            assert a["words"] == b["words"]
            assert a["alignment"] == b["alignment"]
            assert a["final_reached"] == b["final_reached"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-4

    def test_partial_monotone(self):
        g = random_graph(seed=5)
        ll = self._loglikes(seed=6)
        dec = StreamingDecoder(g, acoustic_scale=0.7)
        st = dec.init(ll.shape[0])
        st = dec.feed(st, ll[:, :8])
        p1 = dec.partial(st)
        assert len(p1) == ll.shape[0]
        assert all(len(r["alignment"]) == 8 for r in p1)
        assert all(not r["final_reached"] for r in p1)
        st = dec.feed(st, ll[:, 8:16])
        p2 = dec.partial(st)
        assert all(len(r["alignment"]) == 16 for r in p2)


class TestWindowedStreamingDecoder:
    """HCLG-scale streaming (windowed commits):
    bounded backpointer window + traceback-delay commits, reusing the
    offline kernels (arc-parallel below 64K arcs, tree-ELL above)."""

    def _loglikes(self, B=3, T=48, P=6, seed=2, peaky=0.0):
        rng = np.random.default_rng(seed)
        ll = rng.normal(size=(B, T, P)).astype(np.float32)
        return ll * (1.0 + peaky)

    @pytest.mark.parametrize("layout", ["arc", "tree"])
    def test_window_covers_stream_matches_offline(self, layout):
        """window >= T: nothing commits early, finalize must equal the
        offline decode EXACTLY (both layouts -> also pins tree-chunk
        kernel parity with the offline tree scan)."""
        from kaldi_fp16_tpu.decode.streaming import WindowedStreamingDecoder
        g = random_graph()
        ll = self._loglikes()
        offline = SparseViterbiDecoder(g, acoustic_scale=0.7,
                                       layout="segment").decode_batch(ll)
        dec = WindowedStreamingDecoder(g, acoustic_scale=0.7, window=64,
                                       layout=layout)
        st = dec.init(ll.shape[0])
        for t0 in range(0, ll.shape[1], 8):
            st = dec.feed(st, ll[:, t0:t0 + 8])
        assert st.committed == ()          # window never overflowed
        got = dec.finalize(st)
        for a, b in zip(got, offline):
            assert a["words"] == b["words"]
            assert a["alignment"] == b["alignment"]
            assert a["final_reached"] == b["final_reached"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-4

    def test_bounded_window_and_commits(self):
        """Long stream, small window: device backpointer frames stay
        <= window + chunk while committed frames grow — the memory
        bound that makes HCLG streaming feasible."""
        from kaldi_fp16_tpu.decode.streaming import WindowedStreamingDecoder
        g = random_graph(seed=5)
        T, C, W = 96, 8, 16
        ll = self._loglikes(T=T, seed=6)
        dec = WindowedStreamingDecoder(g, acoustic_scale=0.7, window=W)
        st = dec.init(ll.shape[0])
        for t0 in range(0, T, C):
            st = dec.feed(st, ll[:, t0:t0 + C])
            assert st.window_frames <= W + C
        assert st.committed_frames == T - st.window_frames
        assert st.committed_frames >= T - W - C
        res = dec.finalize(st)
        assert all(len(r["alignment"]) in (0, T) for r in res)

    def test_commit_exactness_when_converged(self):
        """Delay-adjusted exactness contract: with strongly-peaked
        acoustics the best path converges within the window, so the
        windowed decode must equal the offline decode despite commits."""
        from kaldi_fp16_tpu.decode.streaming import WindowedStreamingDecoder
        g = random_graph(seed=7)
        T, C, W = 64, 8, 16
        ll = self._loglikes(T=T, seed=8, peaky=9.0)   # decisive evidence
        offline = SparseViterbiDecoder(g, acoustic_scale=0.7,
                                       layout="segment").decode_batch(ll)
        dec = WindowedStreamingDecoder(g, acoustic_scale=0.7, window=W)
        st = dec.init(ll.shape[0])
        for t0 in range(0, T, C):
            st = dec.feed(st, ll[:, t0:t0 + C])
        assert st.committed_frames > 0
        got = dec.finalize(st)
        for a, b in zip(got, offline):
            assert a["words"] == b["words"]
            assert a["alignment"] == b["alignment"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-4

    def test_partial_includes_committed_prefix(self):
        from kaldi_fp16_tpu.decode.streaming import WindowedStreamingDecoder
        g = random_graph(seed=9)
        T, C, W = 48, 8, 16
        ll = self._loglikes(T=T, seed=10)
        dec = WindowedStreamingDecoder(g, acoustic_scale=0.7, window=W)
        st = dec.init(ll.shape[0])
        for t0 in range(0, T, C):
            st = dec.feed(st, ll[:, t0:t0 + C])
        p = dec.partial(st)
        assert all(len(r["alignment"]) == T for r in p)
        assert all(not r["final_reached"] for r in p)

    def test_tree_layout_matches_arc_layout_with_commits(self):
        """Same stream, same window, both kernels: identical results
        (the tree chunk kernel is the one HCLG-scale graphs use)."""
        from kaldi_fp16_tpu.decode.streaming import WindowedStreamingDecoder
        g = random_graph(seed=11)
        T, C, W = 64, 8, 16
        ll = self._loglikes(T=T, seed=12, peaky=4.0)
        outs = []
        for layout in ("arc", "tree"):
            dec = WindowedStreamingDecoder(g, acoustic_scale=0.7,
                                           window=W, layout=layout)
            st = dec.init(ll.shape[0])
            for t0 in range(0, T, C):
                st = dec.feed(st, ll[:, t0:t0 + C])
            outs.append(dec.finalize(st))
        for a, b in zip(*outs):
            assert a["words"] == b["words"]
            assert a["alignment"] == b["alignment"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-4


class TestStreamingPipeline:
    def test_end_to_end(self, net):
        model, params, state = net
        rng = np.random.default_rng(3)
        enc = StreamingEncoder(model, params, state, chunk_out=4,
                               compute_dtype=jnp.float32)
        g = random_graph()
        pipe = StreamingPipeline(enc, StreamingDecoder(g))
        B, T_out = 2, 12
        x = rng.normal(size=(B, T_out * 3, 8)).astype(np.float32)
        st = pipe.init(B)
        for i in range(T_out * 3 // enc.cin):
            st = pipe.feed(st, x[:, i * enc.cin:(i + 1) * enc.cin])
        res = pipe.finalize(st)
        assert len(res) == B
        # equals offline: encoder reference posteriors -> offline decode
        ref_posts = np.asarray(enc.offline_reference(
            params, state, jnp.asarray(x), compute_dtype=jnp.float32))
        offline = SparseViterbiDecoder(g, layout="segment").decode_batch(
            ref_posts)
        for a, b in zip(res, offline):
            assert a["words"] == b["words"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-3
