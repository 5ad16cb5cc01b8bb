"""Dense on-device Viterbi vs the host beam decoder (must agree on the best
path for unpruned search over epsilon-free graphs)."""

import numpy as np
import pytest

from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.decode.graph import DecodingGraph
from kaldi_fp16_tpu.decode.viterbi import DecodeOptions, ViterbiDecoder
from kaldi_fp16_tpu.decode.tpu_viterbi import DenseGraph, DenseViterbiDecoder
from tests.test_decoder import loglikes_for


def eps_free_graph():
    """Two words as in test_decoder, but the loop-back is an emitting arc
    (epsilon-free for the dense decoder)."""
    s = [FstState() for _ in range(5)]
    s[0].arcs.append(FstArc(1, 0.0, 1, olabel=0))
    s[1].arcs.append(FstArc(2, 0.0, 4, olabel=1))
    s[0].arcs.append(FstArc(3, 0.0, 2, olabel=0))
    s[2].arcs.append(FstArc(4, 0.0, 4, olabel=2))
    # emitting loop-back arcs restart a word from state 4
    s[4].arcs.append(FstArc(1, 0.1, 1, olabel=0))
    s[4].arcs.append(FstArc(3, 0.1, 2, olabel=0))
    s[4].final = 0.0
    return Fst(start=0, states=s)


class TestDenseGraph:
    def test_build(self):
        dg = DenseGraph.from_graph(DecodingGraph.from_fst(eps_free_graph()))
        assert dg.num_states == 5
        assert dg.trans[0, 1] == 0.0
        assert dg.trans[0, 3] <= -1e29  # no arc
        assert dg.pdf[0, 1] == 0        # ilabel 1 -> pdf 0
        assert dg.olabel[1, 4] == 1

    def test_rejects_epsilon(self):
        from tests.test_decoder import two_word_graph
        with pytest.raises(ValueError):
            DenseGraph.from_graph(DecodingGraph.from_fst(two_word_graph()))


class TestDenseViterbi:
    def test_single_word(self):
        dec = DenseViterbiDecoder(DecodingGraph.from_fst(eps_free_graph()))
        res = dec.decode_batch(loglikes_for([1, 2])[None])
        assert res[0]["words"] == [1]
        assert res[0]["alignment"] == [1, 2]

    def test_word_sequence(self):
        dec = DenseViterbiDecoder(DecodingGraph.from_fst(eps_free_graph()))
        # [1,2] word1, then restart via emitting arc pdf1, then [2] -> word1
        res = dec.decode_batch(loglikes_for([1, 2, 1, 2])[None])
        assert res[0]["words"] == [1, 1]

    def test_batch_matches_host_decoder(self):
        g = DecodingGraph.from_fst(eps_free_graph())
        dense = DenseViterbiDecoder(g)
        host = ViterbiDecoder(g, DecodeOptions(beam=1e9, max_active=10 ** 9))
        lls = np.stack([loglikes_for([1, 2]), loglikes_for([3, 4]),
                        loglikes_for([1, 2, 3, 4])[:2]])
        dres = dense.decode_batch(lls)
        for b in range(3):
            hres = host.decode(lls[b])
            assert dres[b]["words"] == hres.words, b
            np.testing.assert_allclose(dres[b]["total_cost"], hres.total_cost,
                                       atol=1e-4)

    def test_acoustic_scale(self):
        g = DecodingGraph.from_fst(eps_free_graph())
        g.em_weight[g.em_ilabel == 1] = 3.0  # penalize word-1 entry
        dec_full = DenseViterbiDecoder(g, acoustic_scale=1.0)
        dec_scaled = DenseViterbiDecoder(g, acoustic_scale=0.1)
        lls = loglikes_for([1, 2], good=10.0)[None]
        assert dec_full.decode_batch(lls)[0]["words"] == [1]
        assert dec_scaled.decode_batch(lls)[0]["words"] == [2]


def random_eps_free_graph(S=40, P=12, E=4, seed=3):
    rng = np.random.default_rng(seed)
    states = [FstState() for _ in range(S)]
    for s in range(S):
        for d in rng.choice(S, size=E, replace=False):
            states[s].arcs.append(FstArc(
                int(rng.integers(1, P + 1)), float(rng.uniform(0, 2)),
                int(d), olabel=int(rng.integers(0, 5))))
        states[s].final = float(rng.uniform(0, 1))
    return Fst(start=0, states=states)


class TestSparseViterbi:
    """Arc-parallel decoder must reproduce the dense decoder exactly."""

    def test_single_word(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        dec = SparseViterbiDecoder(DecodingGraph.from_fst(eps_free_graph()))
        res = dec.decode_batch(loglikes_for([1, 2])[None])
        assert res[0]["words"] == [1]
        assert res[0]["alignment"] == [1, 2]

    def test_matches_dense_on_random_graphs(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        for seed in (3, 4, 5):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            dense = DenseViterbiDecoder(g)
            sparse = SparseViterbiDecoder(g)
            rng = np.random.default_rng(seed)
            lls = rng.normal(size=(3, 9, 12)).astype(np.float32)
            dres = dense.decode_batch(lls)
            sres = sparse.decode_batch(lls)
            for b in range(3):
                np.testing.assert_allclose(
                    sres[b]["total_cost"], dres[b]["total_cost"],
                    atol=1e-4, err_msg=f"seed={seed} b={b}")
                assert sres[b]["words"] == dres[b]["words"], (seed, b)
                assert sres[b]["alignment"] == dres[b]["alignment"], (seed, b)

    def test_matches_host_decoder(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g = DecodingGraph.from_fst(eps_free_graph())
        sparse = SparseViterbiDecoder(g)
        host = ViterbiDecoder(g, DecodeOptions(beam=1e9, max_active=10 ** 9))
        lls = np.stack([loglikes_for([1, 2]), loglikes_for([3, 4])])
        sres = sparse.decode_batch(lls)
        for b in range(2):
            hres = host.decode(lls[b])
            assert sres[b]["words"] == hres.words, b
            np.testing.assert_allclose(sres[b]["total_cost"],
                                       hres.total_cost, atol=1e-4)

    def test_rejects_epsilon(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import ArcGraph
        from tests.test_decoder import two_word_graph
        with pytest.raises(ValueError):
            ArcGraph.from_graph(DecodingGraph.from_fst(two_word_graph()))


class TestDeviceLattice:
    """DeviceLatticeDecoder: the exact alpha+arc+beta criterion must give
    the same pruned lattice as the host token-passing decoder when the
    host's decode beam is wide open."""

    def _host_lat(self, g, ll, lattice_beam):
        from kaldi_fp16_tpu.decode.lattice import (
            LatticeDecodeOptions, LatticeDecoder,
        )
        return LatticeDecoder(g, LatticeDecodeOptions(
            beam=1e9, max_active=10 ** 9,
            lattice_beam=lattice_beam)).decode(ll)

    @staticmethod
    def _arc_set(lat):
        frames = lat.node_frame
        return {(int(frames[a.src]), a.ilabel, a.olabel,
                 round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                for a in lat.arcs}

    def test_matches_host_lattice(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        for seed in (0, 1, 2):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            rng = np.random.default_rng(seed + 10)
            ll = rng.normal(size=(7, 12)).astype(np.float32)
            for beam in (2.0, 6.0):
                host = self._host_lat(g, ll, beam)
                dev = DeviceLatticeDecoder(
                    g, lattice_beam=beam).decode_batch(ll[None])[0]
                assert self._arc_set(dev) == self._arc_set(host), (
                    seed, beam)
                hw, hc = host.best_path()
                dw, dc = dev.best_path()
                assert hw == dw and abs(hc - dc) < 1e-4

    def test_nbest_and_rescoring_machinery_works(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(eps_free_graph())
        ll = loglikes_for([1, 2, 1, 2])
        lat = DeviceLatticeDecoder(g, lattice_beam=20.0).decode_batch(
            ll[None])[0]
        nb = lat.n_best(3)
        assert nb and nb[0][0] == lat.best_path()[0]
        # acoustic rescaling without re-decoding
        w_scaled, _ = lat.best_path(acoustic_scale=0.01)
        assert isinstance(w_scaled, list)

    def test_batched(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=5))
        rng = np.random.default_rng(6)
        lls = rng.normal(size=(3, 6, 12)).astype(np.float32)
        dec = DeviceLatticeDecoder(g, lattice_beam=4.0)
        lats = dec.decode_batch(lls)
        for b in range(3):
            host = self._host_lat(g, lls[b], 4.0)
            assert self._arc_set(lats[b]) == self._arc_set(host), b

    def test_compact_transfer_matches_dense(self):
        """Device-side nonzero-byte compaction (transfer='compact') must
        produce byte-identical lattices to the dense mask transfer, for
        both kernel layouts."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        for seed in (0, 3):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            rng = np.random.default_rng(seed + 20)
            lls = rng.normal(size=(3, 9, 12)).astype(np.float32)
            for layout in ("segment", "tree"):
                dense = DeviceLatticeDecoder(
                    g, lattice_beam=5.0, layout=layout,
                    transfer="dense").decode_batch(lls)
                comp = DeviceLatticeDecoder(
                    g, lattice_beam=5.0, layout=layout,
                    transfer="compact").decode_batch(lls)
                for b in range(3):
                    assert (self._arc_set(comp[b])
                            == self._arc_set(dense[b])), (seed, layout, b)
                    assert comp[b].num_nodes == dense[b].num_nodes

    def test_compact_overflow_falls_back_dense(self):
        """count > compact_cap must silently use the dense transfer —
        correctness never depends on the cap."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=1))
        rng = np.random.default_rng(30)
        lls = rng.normal(size=(2, 8, 12)).astype(np.float32)
        dense = DeviceLatticeDecoder(
            g, lattice_beam=20.0, transfer="dense").decode_batch(lls)
        tiny = DeviceLatticeDecoder(
            g, lattice_beam=20.0, transfer="compact",
            compact_cap=2).decode_batch(lls)        # guaranteed overflow
        for b in range(2):
            assert self._arc_set(tiny[b]) == self._arc_set(dense[b])

    def test_unreachable_final_keeps_nothing(self):
        """best == INF must not saturate the beam threshold into
        keep-everything (fp32: INF + beam == INF)."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        s = [FstState() for _ in range(4)]
        s[0].arcs.append(FstArc(1, 0.0, 1))
        s[1].arcs.append(FstArc(2, 0.0, 2))
        s[2].arcs.append(FstArc(3, 0.0, 3))
        s[3].final = 0.0                      # only state 3 final
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        ll = np.zeros((1, 2, 12), np.float32)   # T=2 < 3 needed
        lat = DeviceLatticeDecoder(g, lattice_beam=8.0).decode_batch(ll)[0]
        assert len(lat.arcs) == 0
        words, cost = lat.best_path()
        assert words == [] and not np.isfinite(cost)


class TestEpsilonRemoval:
    """remove_epsilons lets real (eps-carrying) HCLG graphs feed the
    on-device decoders; must preserve best paths exactly."""

    @staticmethod
    def random_eps_graph(S=20, P=8, E=3, NEPS=12, seed=0):
        rng = np.random.default_rng(seed)
        s = [FstState() for _ in range(S)]
        for i in range(S):
            for d in rng.choice(S, size=E, replace=False):
                s[i].arcs.append(FstArc(
                    int(rng.integers(1, P + 1)), float(rng.uniform(0, 2)),
                    int(d), olabel=int(rng.integers(0, 4))))
            s[i].final = float(rng.uniform(0, 1))
        for _ in range(NEPS):
            a, b = rng.choice(S, size=2, replace=False)
            s[int(a)].arcs.append(FstArc(
                0, float(rng.uniform(0, 1)), int(b),
                olabel=int(rng.integers(0, 4))))
        return Fst(start=0, states=s)

    def test_best_path_preserved(self):
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        for seed in (0, 1, 2, 3):
            g = DecodingGraph.from_fst(self.random_eps_graph(seed=seed))
            ge = remove_epsilons(g)
            assert len(ge.eps_dst) == 0
            host = ViterbiDecoder(g, DecodeOptions(beam=1e9,
                                                   max_active=10 ** 9))
            dev = SparseViterbiDecoder(ge)
            rng = np.random.default_rng(seed + 100)
            lls = rng.normal(size=(2, 7, 8)).astype(np.float32)
            res = dev.decode_batch(lls)
            for b in range(2):
                hres = host.decode(lls[b])
                np.testing.assert_allclose(res[b]["total_cost"],
                                           hres.total_cost, atol=1e-4,
                                           err_msg=f"seed={seed} b={b}")

    def test_noop_on_eps_free(self):
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        g = DecodingGraph.from_fst(eps_free_graph())
        ge = remove_epsilons(g)
        assert len(ge.em_dst) == len(g.em_dst)
        np.testing.assert_allclose(ge.em_weight, g.em_weight)
        np.testing.assert_allclose(ge.final_cost, g.final_cost)

    def test_words_preserved_with_pushed_labels(self):
        """With word labels pushed onto emitting arcs (eps arcs
        unlabeled, the HCLG-pushed construction), WORDS must match the
        host decoder on the original graph, not just costs."""
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        rng = np.random.default_rng(7)
        for seed in (0, 1, 2):
            fst = self.random_eps_graph(seed=seed)
            for st in fst.states:           # strip eps olabels
                for a in st.arcs:
                    if a.label == 0:
                        a.olabel = 0
            g = DecodingGraph.from_fst(fst)
            ge = remove_epsilons(g)
            host = ViterbiDecoder(g, DecodeOptions(beam=1e9,
                                                   max_active=10 ** 9))
            dev = SparseViterbiDecoder(ge)
            lls = rng.normal(size=(2, 6, 8)).astype(np.float32)
            res = dev.decode_batch(lls)
            for b in range(2):
                hres = host.decode(lls[b])
                assert res[b]["words"] == hres.words, (seed, b)
                np.testing.assert_allclose(res[b]["total_cost"],
                                           hres.total_cost, atol=1e-4)

    def test_lossy_labels_warned(self, capsys):
        """A labeled eps arc into a labeled emitting arc must be counted
        and warned, not silently dropped."""
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        s = [FstState() for _ in range(3)]
        s[0].arcs.append(FstArc(0, 0.1, 1, olabel=7))     # labeled eps
        s[1].arcs.append(FstArc(2, 0.0, 2, olabel=9))     # labeled emitting
        s[2].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        remove_epsilons(g)
        err = capsys.readouterr().err
        assert "lost word labels" in err


class TestEllLayout:
    """The scatter-free ELL kernels must reproduce the segment-reduce
    kernels EXACTLY — costs, words, alignments (incl. smallest-arc-id
    tie-breaking) and lattice arc sets."""

    def test_viterbi_ell_matches_segment(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        for seed in (3, 4, 5):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            ell = SparseViterbiDecoder(g, layout="ell")
            seg = SparseViterbiDecoder(g, layout="segment")
            rng = np.random.default_rng(seed + 100)
            lls = rng.normal(size=(3, 9, 12)).astype(np.float32)
            eres = ell.decode_batch(lls)
            sres = seg.decode_batch(lls)
            for b in range(3):
                np.testing.assert_allclose(
                    eres[b]["total_cost"], sres[b]["total_cost"], atol=1e-4)
                assert eres[b]["words"] == sres[b]["words"], (seed, b)
                assert eres[b]["alignment"] == sres[b]["alignment"], (seed, b)
                assert eres[b]["final_reached"] == sres[b]["final_reached"]

    def test_tie_breaking_matches(self):
        """Two arcs with IDENTICAL candidate scores into one state: both
        layouts must pick the same (smallest) arc id."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        s = [FstState() for _ in range(3)]
        # two arcs 0->1 with the same weight/pdf but different olabels
        s[0].arcs.append(FstArc(1, 0.5, 1, olabel=7))
        s[0].arcs.append(FstArc(1, 0.5, 1, olabel=8))
        s[1].arcs.append(FstArc(2, 0.0, 2, olabel=0))
        s[2].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        ll = np.zeros((1, 2, 3), np.float32)
        eres = SparseViterbiDecoder(g, layout="ell").decode_batch(ll)
        sres = SparseViterbiDecoder(g, layout="segment").decode_batch(ll)
        assert eres[0]["words"] == sres[0]["words"] == [7]

    def test_high_fanin_buckets(self):
        """Non-power-of-two fan-in lands in a padded bucket; decode must
        still be exact vs the dense reference."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import (
            ArcGraph, EllGraph, SparseViterbiDecoder)
        rng = np.random.default_rng(0)
        n = 37
        s = [FstState() for _ in range(n + 2)]
        sink = n + 1
        for i in range(1, n + 1):
            s[0].arcs.append(FstArc(int(rng.integers(1, 6)),
                                    float(rng.uniform(0, 2)), i,
                                    olabel=i))
            s[i].arcs.append(FstArc(int(rng.integers(1, 6)),
                                    float(rng.uniform(0, 2)), sink,
                                    olabel=0))
        s[sink].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        ell = EllGraph.from_arcs(ArcGraph.from_graph(g), "in")
        assert max(a.shape[1] for a in ell.src) >= 37  # sink's bucket
        total = sum(a.size for a in ell.src)
        assert total <= 2 * ell.num_arcs + ell.num_states + 64  # bounded pad
        ll = rng.normal(size=(2, 2, 5)).astype(np.float32)
        eres = SparseViterbiDecoder(g, layout="ell").decode_batch(ll)
        dres = DenseViterbiDecoder(g).decode_batch(ll)
        for b in range(2):
            np.testing.assert_allclose(eres[b]["total_cost"],
                                       dres[b]["total_cost"], atol=1e-4)
            assert eres[b]["words"] == dres[b]["words"]

    def test_lattice_ell_matches_segment(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        for seed in (0, 1, 2):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            rng = np.random.default_rng(seed + 10)
            lls = rng.normal(size=(2, 7, 12)).astype(np.float32)
            for beam in (2.0, 6.0):
                el = DeviceLatticeDecoder(g, lattice_beam=beam,
                                          layout="ell").decode_batch(lls)
                sl = DeviceLatticeDecoder(g, lattice_beam=beam,
                                          layout="segment").decode_batch(lls)
                for b in range(2):
                    ea = {(int(el[b].node_frame[a.src]), a.ilabel, a.olabel,
                           round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                          for a in el[b].arcs}
                    sa = {(int(sl[b].node_frame[a.src]), a.ilabel, a.olabel,
                           round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                          for a in sl[b].arcs}
                    assert ea == sa, (seed, beam, b)


class TestCheckpointedLattice:
    def test_ckpt_matches_plain(self):
        """The checkpointed-alpha kernel must produce the IDENTICAL
        packed mask set as the plain kernel (same arcs kept)."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=9))
        rng = np.random.default_rng(7)
        ll = rng.normal(size=(2, 12, 12)).astype(np.float32)
        ref = DeviceLatticeDecoder(g, lattice_beam=5.0)
        ck = DeviceLatticeDecoder(g, lattice_beam=5.0)
        ck.alpha_hist_limit = 12 * g.num_states * 2 * 4 // 3  # force ckpt
        rl = ref.decode_batch(ll)
        cl = ck.decode_batch(ll)
        for b in range(2):
            ra = {(int(rl[b].node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                  for a in rl[b].arcs}
            ca = {(int(cl[b].node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                  for a in cl[b].arcs}
            assert ra == ca, b

    def test_ckpt_chunk_choice(self):
        """chunk must divide T and respect the live-block limit."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=3))
        dec = DeviceLatticeDecoder(g, lattice_beam=4.0)
        dec.alpha_hist_limit = 1  # everything over limit -> chunk=1
        ll = np.random.default_rng(0).normal(size=(1, 6, 12)) \
            .astype(np.float32)
        lats = dec.decode_batch(ll)       # chunk=1 still exact
        assert lats[0].num_nodes >= 1


class TestVectorEpsilonRemoval:
    def test_vector_matches_scalar(self):
        """The flat-array closure must reproduce the per-state Dijkstra
        reference: same arc set (s, d, il, ol, weight) and finals."""
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        for seed in range(6):
            g = DecodingGraph.from_fst(
                TestEpsilonRemoval.random_eps_graph(
                    S=24, NEPS=18, seed=seed))
            a = remove_epsilons(g, method="scalar")
            b = remove_epsilons(g, method="vector")
            np.testing.assert_allclose(a.final_cost, b.final_cost,
                                       atol=1e-9, err_msg=str(seed))

            def arcset(x):
                src = np.repeat(np.arange(x.num_states),
                                np.diff(x.em_row_ptr))
                return sorted(zip(src.tolist(), x.em_dst.tolist(),
                                  x.em_ilabel.tolist(),
                                  x.em_olabel.tolist(),
                                  np.round(x.em_weight, 9).tolist()))
            assert arcset(a) == arcset(b), seed

    def test_vector_eps_chains_and_cycles(self):
        """Depth-3 eps chains and a zero-ish-weight eps cycle must
        converge and match the scalar reference."""
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        s = [FstState() for _ in range(6)]
        s[0].arcs.append(FstArc(0, 0.1, 1, olabel=0))
        s[1].arcs.append(FstArc(0, 0.1, 2, olabel=0))
        s[2].arcs.append(FstArc(0, 0.1, 3, olabel=0))
        s[3].arcs.append(FstArc(1, 0.5, 4, olabel=7))
        s[2].arcs.append(FstArc(0, 0.0, 1, olabel=0))   # eps cycle 1-2
        s[4].arcs.append(FstArc(2, 0.2, 5, olabel=0))
        s[5].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        a = remove_epsilons(g, method="scalar")
        b = remove_epsilons(g, method="vector")
        np.testing.assert_allclose(a.final_cost, b.final_cost)
        np.testing.assert_allclose(np.sort(a.em_weight),
                                   np.sort(b.em_weight))

    def test_vector_scales(self):
        """A 30K-state graph with eps word-exit arcs epsilon-removes in
        seconds via the vector path (the scalar path is per-state
        Python Dijkstra — minutes at this size)."""
        import time
        from kaldi_fp16_tpu.decode.graph import DecodingGraph as DG
        from kaldi_fp16_tpu.decode.graph import remove_epsilons
        rng = np.random.default_rng(0)
        S, word_len = 30000, 10
        W = S // word_len
        sid = np.arange(S, dtype=np.int64)
        k = sid % word_len
        srcs = [sid]; dsts = [sid]
        ils = [(sid % 64) + 1]; ols = [np.zeros(S, np.int64)]
        ws = [rng.uniform(0.2, 1.0, S)]
        adv = sid[k < word_len - 1]
        srcs.append(adv); dsts.append(adv + 1)
        ils.append((adv % 64) + 2); ols.append(np.zeros(len(adv), np.int64))
        ws.append(rng.uniform(0.2, 1.0, len(adv)))
        # EPS word-exit arcs carrying the word label (the construction
        # remove_epsilons exists for)
        ends = sid[k == word_len - 1]
        succ = rng.integers(0, W, size=(len(ends), 4))
        srcs.append(np.repeat(ends, 4)); dsts.append(succ.reshape(-1) * word_len)
        ils.append(np.zeros(len(ends) * 4, np.int64))
        ols.append(np.repeat((ends // word_len) + 1, 4))
        ws.append(rng.uniform(0.5, 2.0, len(ends) * 4))
        g = DG.from_arrays(
            num_states=S, start=0,
            src=np.concatenate(srcs), dst=np.concatenate(dsts),
            ilabel=np.concatenate(ils), olabel=np.concatenate(ols),
            weight=np.concatenate(ws),
            final_cost=rng.uniform(0, 1, S))
        t0 = time.perf_counter()
        ge = remove_epsilons(g)          # auto -> vector at this size
        dt = time.perf_counter() - t0
        assert len(ge.eps_dst) == 0
        assert dt < 30.0, f"vector eps removal took {dt:.1f}s"
        # words survived onto emitting arcs
        assert (ge.em_olabel > 0).sum() >= len(ends)


class TestCheckpointedViterbi:
    def test_ckpt_matches_plain(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        for seed in (2, 5):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            rng = np.random.default_rng(seed)
            ll = rng.normal(size=(3, 12, 12)).astype(np.float32)
            ref = SparseViterbiDecoder(g)
            ck = SparseViterbiDecoder(g)
            ck.bp_hist_limit = 12 * g.num_states * 3 * 4 // 4  # force ckpt
            rr = ref.decode_batch(ll)
            cc = ck.decode_batch(ll)
            for b in range(3):
                assert rr[b]["words"] == cc[b]["words"], (seed, b)
                assert rr[b]["alignment"] == cc[b]["alignment"], (seed, b)
                np.testing.assert_allclose(rr[b]["total_cost"],
                                           cc[b]["total_cost"], atol=1e-4)


class TestRaggedChunk:
    """Prime T (no divisors) must work via the ragged final chunk —
    the divisor-based picker degraded to chunk=1 (review finding)."""

    def test_viterbi_prime_T(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import (
            SparseViterbiDecoder, _pick_chunk)
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=4))
        rng = np.random.default_rng(1)
        ll = rng.normal(size=(2, 13, 12)).astype(np.float32)   # T=13 prime
        ref = SparseViterbiDecoder(g)
        ck = SparseViterbiDecoder(g)
        ck.bp_hist_limit = 13 * g.num_states * 2 * 4 // 3
        chunk = _pick_chunk(13, g.num_states, 2, ck.bp_hist_limit)
        assert 1 < chunk < 13 and 13 % chunk != 0   # genuinely ragged
        rr, cc = ref.decode_batch(ll), ck.decode_batch(ll)
        for b in range(2):
            assert rr[b]["words"] == cc[b]["words"]
            assert rr[b]["alignment"] == cc[b]["alignment"]
            np.testing.assert_allclose(rr[b]["total_cost"],
                                       cc[b]["total_cost"], atol=1e-4)

    def test_lattice_prime_T(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=8))
        rng = np.random.default_rng(2)
        ll = rng.normal(size=(2, 11, 12)).astype(np.float32)   # T=11 prime
        ref = DeviceLatticeDecoder(g, lattice_beam=5.0)
        ck = DeviceLatticeDecoder(g, lattice_beam=5.0)
        ck.alpha_hist_limit = 11 * g.num_states * 2 * 4 // 3
        rl, cl = ref.decode_batch(ll), ck.decode_batch(ll)
        for b in range(2):
            ra = {(int(rl[b].node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4)) for a in rl[b].arcs}
            ca = {(int(cl[b].node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4)) for a in cl[b].arcs}
            assert ra == ca, b


def test_ell_layout_rejects_oversized_alpha_history():
    """layout='ell' materializes the full [T,S,B] alpha history; above
    alpha_hist_limit it must refuse loudly (pointing at the segment
    layout's checkpointed kernel) instead of attempting a multi-GiB
    allocation the segment path was explicitly hardened against."""
    import pytest
    from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
    g = DecodingGraph.from_fst(random_eps_free_graph(seed=3))
    dec = DeviceLatticeDecoder(g, lattice_beam=4.0, layout="ell")
    dec.alpha_hist_limit = 1024          # force the guard at toy scale
    rng = np.random.default_rng(7)
    ll = rng.normal(size=(2, 8, 12)).astype(np.float32)
    with pytest.raises(ValueError, match="alpha_hist_limit"):
        dec.decode_batch(ll)
    # under the limit the ELL path still works and matches segment
    dec.alpha_hist_limit = 1 << 30
    lats = dec.decode_batch(ll)
    ref = DeviceLatticeDecoder(g, lattice_beam=4.0).decode_batch(ll)
    for a, b in zip(lats, ref):
        assert TestDeviceLattice._arc_set(a) == TestDeviceLattice._arc_set(b)


class TestTreeLayout:
    """The capped multi-level (tree-ELL) kernels must reproduce the
    segment-reduce kernels EXACTLY — costs, words, alignments (incl.
    smallest-arc-id tie-breaking) and lattice arc sets — including with
    widths small enough to force several reduce levels."""

    def _hub_graph(self, fanin=53, seed=0):
        """start -> {mid_i} -> sink with a huge fan-in at the sink, so a
        small max_width forces ceil(fanin/W) level-1 rows + extra levels."""
        rng = np.random.default_rng(seed)
        s = [FstState() for _ in range(fanin + 2)]
        sink = fanin + 1
        for i in range(1, fanin + 1):
            s[0].arcs.append(FstArc(int(rng.integers(1, 6)),
                                    float(rng.uniform(0, 2)), i, olabel=i))
            s[i].arcs.append(FstArc(int(rng.integers(1, 6)),
                                    float(rng.uniform(0, 2)), sink, olabel=0))
        s[sink].final = 0.0
        return DecodingGraph.from_fst(Fst(start=0, states=s))

    def test_viterbi_tree_matches_segment(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        for seed in (3, 4, 5):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            tree = SparseViterbiDecoder(g, layout="tree", tree_max_width=4)
            seg = SparseViterbiDecoder(g, layout="segment")
            rng = np.random.default_rng(seed + 100)
            lls = rng.normal(size=(3, 9, 12)).astype(np.float32)
            tres = tree.decode_batch(lls)
            sres = seg.decode_batch(lls)
            for b in range(3):
                np.testing.assert_allclose(
                    tres[b]["total_cost"], sres[b]["total_cost"], atol=1e-4)
                assert tres[b]["words"] == sres[b]["words"], (seed, b)
                assert tres[b]["alignment"] == sres[b]["alignment"], (seed, b)
                assert tres[b]["final_reached"] == sres[b]["final_reached"]

    def test_tree_multi_level_hub(self):
        """Fan-in 53 at width 4 needs 14 level-1 rows -> 4 -> 1: three
        reduce levels; results must still match the segment kernel."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import (
            ArcGraph, SparseViterbiDecoder, TreeEllGraph)
        g = self._hub_graph()
        t = TreeEllGraph.from_arcs(ArcGraph.from_graph(g), "in", max_width=4)
        assert len(t.levels) >= 2
        # every level-1 row is capped
        assert max(x.shape[1] for x in t.src) <= 4
        # bounded padding: slots <= 2*A + S (pow2 round-up + empty rows)
        total = sum(x.size for x in t.src)
        assert total <= 2 * t.num_arcs + t.num_states + 64
        rng = np.random.default_rng(9)
        lls = rng.normal(size=(2, 2, 5)).astype(np.float32)
        tres = SparseViterbiDecoder(
            g, layout="tree", tree_max_width=4).decode_batch(lls)
        sres = SparseViterbiDecoder(g, layout="segment").decode_batch(lls)
        for b in range(2):
            np.testing.assert_allclose(
                tres[b]["total_cost"], sres[b]["total_cost"], atol=1e-4)
            assert tres[b]["words"] == sres[b]["words"]
            assert tres[b]["alignment"] == sres[b]["alignment"]

    def test_tree_tie_breaking_matches(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        s = [FstState() for _ in range(3)]
        s[0].arcs.append(FstArc(1, 0.5, 1, olabel=7))
        s[0].arcs.append(FstArc(1, 0.5, 1, olabel=8))
        s[1].arcs.append(FstArc(2, 0.0, 2, olabel=0))
        s[2].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        ll = np.zeros((1, 2, 3), np.float32)
        tres = SparseViterbiDecoder(
            g, layout="tree", tree_max_width=2).decode_batch(ll)
        sres = SparseViterbiDecoder(g, layout="segment").decode_batch(ll)
        assert tres[0]["words"] == sres[0]["words"] == [7]

    def test_tree_cross_row_tie_break(self):
        """Equal-score arcs split across DIFFERENT level-1 rows (fan-in >
        width, identical weights): the smallest arc id must win in both
        layouts."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        n = 9
        s = [FstState() for _ in range(n + 2)]
        sink = n + 1
        for i in range(1, n + 1):
            s[0].arcs.append(FstArc(1, 0.5, i, olabel=i))
            s[i].arcs.append(FstArc(2, 0.5, sink, olabel=100 + i))
        s[sink].final = 0.0
        g = DecodingGraph.from_fst(Fst(start=0, states=s))
        ll = np.zeros((1, 2, 3), np.float32)
        tres = SparseViterbiDecoder(
            g, layout="tree", tree_max_width=2).decode_batch(ll)
        sres = SparseViterbiDecoder(g, layout="segment").decode_batch(ll)
        assert tres[0]["words"] == sres[0]["words"]
        assert tres[0]["alignment"] == sres[0]["alignment"]

    def test_tree_checkpointed_path(self):
        """Forcing bp_hist_limit low must route to _tree_viterbi_ckpt and
        still match the segment kernel exactly."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=6))
        tree = SparseViterbiDecoder(g, layout="tree", tree_max_width=4)
        tree.bp_hist_limit = 64          # force the remat kernel
        seg = SparseViterbiDecoder(g, layout="segment")
        rng = np.random.default_rng(11)
        lls = rng.normal(size=(2, 11, 12)).astype(np.float32)
        tres = tree.decode_batch(lls)
        sres = seg.decode_batch(lls)
        for b in range(2):
            np.testing.assert_allclose(
                tres[b]["total_cost"], sres[b]["total_cost"], atol=1e-4)
            assert tres[b]["words"] == sres[b]["words"]
            assert tres[b]["alignment"] == sres[b]["alignment"]

    def test_tree_row_state_and_slot_arc_invariants(self):
        """The slot-order lattice mask relies on two layout invariants:
        every arc occupies exactly ONE level-1 slot (the host permutes
        slot bits to arc ids), and row_state[r] is the reduction-target
        state of every valid slot in row r (the mask gathers alpha at
        it once per row)."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import ArcGraph, TreeEllGraph
        for seed in (0, 3):
            a = ArcGraph.from_graph(
                DecodingGraph.from_fst(random_eps_free_graph(seed=seed)))
            for direction, key in (("in", a.dst), ("out", a.src)):
                t = TreeEllGraph.from_arcs(a, direction, max_width=4)
                slot_arc = np.concatenate([x.reshape(-1) for x in t.arc])
                live = slot_arc[slot_arc < t.num_arcs]
                # exactly one slot per arc
                assert sorted(live.tolist()) == list(range(t.num_arcs))
                # row_state buckets align with the arc tables and own
                # every valid slot's reduction-target state
                assert len(t.row_state) == len(t.arc)
                for arc_b, rs_b in zip(t.arc, t.row_state):
                    assert rs_b.shape == (arc_b.shape[0],)
                    valid = arc_b < t.num_arcs
                    rows, _ = np.nonzero(valid)
                    assert np.array_equal(
                        key[arc_b[valid]], rs_b[rows])
                # every state owns >= 1 row
                assert set(np.concatenate(
                    [x for x in t.row_state]).tolist()) \
                    == set(range(t.num_states))

    def test_lattice_tree_matches_segment(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        for seed in (0, 2):
            g = DecodingGraph.from_fst(random_eps_free_graph(seed=seed))
            rng = np.random.default_rng(seed + 20)
            lls = rng.normal(size=(2, 7, 12)).astype(np.float32)
            for beam in (2.0, 6.0):
                tl = DeviceLatticeDecoder(
                    g, lattice_beam=beam, layout="tree",
                    tree_max_width=4).decode_batch(lls)
                sl = DeviceLatticeDecoder(
                    g, lattice_beam=beam,
                    layout="segment").decode_batch(lls)
                for b in range(2):
                    assert (TestDeviceLattice._arc_set(tl[b])
                            == TestDeviceLattice._arc_set(sl[b])), (seed, b)

    def test_lattice_tree_checkpointed(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=1))
        rng = np.random.default_rng(30)
        lls = rng.normal(size=(2, 9, 12)).astype(np.float32)
        tree = DeviceLatticeDecoder(g, lattice_beam=5.0, layout="tree",
                                    tree_max_width=4)
        tree.alpha_hist_limit = 64       # force the remat kernel
        seg = DeviceLatticeDecoder(g, lattice_beam=5.0, layout="segment")
        tl = tree.decode_batch(lls)
        sl = seg.decode_batch(lls)
        for b in range(2):
            assert (TestDeviceLattice._arc_set(tl[b])
                    == TestDeviceLattice._arc_set(sl[b])), b

    def test_auto_layout_selection(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g = DecodingGraph.from_fst(random_eps_free_graph(seed=7))
        assert SparseViterbiDecoder(g).layout == "segment"   # small graph
