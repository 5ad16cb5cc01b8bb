"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Verifies: mesh construction, dp-sharded training matches the single-device
result, tp-sharded wide heads produce the same numbers, and the dp+tp
combined step runs (the multichip dryrun path)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from kaldi_fp16_tpu.chain.graph import (
    DenominatorGraph, build_numerator_batch, make_simple_den_fst,
)
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu.models.model import build_model_from_string
from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh
from kaldi_fp16_tpu.parallel.data_parallel import (
    make_sharded_train_step, param_shardings, shard_batch,
)
from kaldi_fp16_tpu.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from tests.test_chain_numerator import random_fst

NUM_PDFS = 8
T_IN, T_OUT, STRIDE = 12, 4, 3
B = 8  # divisible by the data axis

XCONFIG = f"""\
input name=input dim=16
linear-component name=linear1 dim=32
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=32 bottleneck-dim=16 time-stride=1 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=16 big-dim=32
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""


def _setup():
    rng = np.random.default_rng(21)
    model = build_model_from_string(XCONFIG)
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=9), NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    csrs = [fst_to_csr(random_fst(rng, num_pdfs=NUM_PDFS, T=T_OUT,
                                  num_states=2 * (T_OUT + 1)))
            for _ in range(B)]
    num_graph = build_numerator_batch(csrs)
    batch = {
        "features": jnp.asarray(rng.normal(size=(B, T_IN, 16)).astype(np.float32)),
        "weights": jnp.ones(B, jnp.float32),
    }
    config = TrainConfig(learning_rate=0.01, momentum=0.5,
                         frame_subsampling_factor=STRIDE,
                         compute_dtype="float32")
    return model, den, num_graph, batch, config


def test_devices_available():
    assert len(jax.devices()) == 8, (
        "conftest must provide 8 virtual CPU devices")


def test_make_mesh_shapes():
    mesh = make_mesh(MeshConfig(data=4, model=2))
    assert mesh.shape == {"data": 4, "seq": 1, "model": 2}
    mesh_dp = make_mesh()
    assert mesh_dp.shape["data"] == 8
    mesh_sp = make_mesh(MeshConfig(data=2, seq=2, model=2))
    assert mesh_sp.shape == {"data": 2, "seq": 2, "model": 2}
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=16, model=1))


@pytest.mark.parametrize("mesh_cfg", [MeshConfig(data=4, model=1),
                                      MeshConfig(data=2, model=2),
                                      MeshConfig(data=1, model=4),
                                      MeshConfig(data=2, seq=2, model=1),
                                      MeshConfig(data=2, seq=2, model=2)])
def test_sharded_matches_single_device(mesh_cfg):
    """dp/tp/sp sharded training must reproduce the single-device numbers.

    The sp cases shard the 12-frame feature time axis over 'seq'; GSPMD
    inserts halo exchanges for the tdnnf temporal splices and re-gathers
    before the chain scan, so the numbers must be identical."""
    model, den, num_graph, batch, config = _setup()
    opts = ChainTrainingOpts()

    # single-device baseline
    step1 = make_train_step(model, den, num_graph, opts, config,
                            num_frames_out=T_OUT, donate=False)
    params, net_state, opt_state, scale_state = init_train_state(
        model, jax.random.PRNGKey(0), config)
    rng = jax.random.PRNGKey(5)
    p1, ns1, os1, ss1, out1 = step1(params, net_state, opt_state, scale_state,
                                    batch, rng)

    # sharded
    mesh = make_mesh(mesh_cfg)
    pure = make_train_step(model, den, num_graph, opts, config,
                           num_frames_out=T_OUT, donate=False, jit=False)
    params2, net_state2, opt_state2, scale_state2 = init_train_state(
        model, jax.random.PRNGKey(0), config)
    sbatch = shard_batch(batch, mesh)
    sstep, placed = make_sharded_train_step(
        pure, mesh, model, params2, net_state2, opt_state2, scale_state2,
        sbatch)
    p2, ns2, os2, ss2, out2 = sstep(*placed, sbatch, rng)

    np.testing.assert_allclose(float(out1.loss), float(out2.loss),
                               rtol=1e-5)
    for lname in p1:
        for pname in p1[lname]:
            np.testing.assert_allclose(
                np.asarray(p1[lname][pname]), np.asarray(p2[lname][pname]),
                rtol=2e-5, atol=1e-6,
                err_msg=f"{lname}/{pname} mismatch under {mesh_cfg}")
    # bn stats replicated and equal
    np.testing.assert_allclose(np.asarray(ns1["bn1"]["mean"]),
                               np.asarray(ns2["bn1"]["mean"]),
                               rtol=1e-5, atol=1e-7)


def test_param_sharding_rules():
    model, den, num_graph, batch, config = _setup()
    params, *_ = init_train_state(model, jax.random.PRNGKey(0), config)
    mesh = make_mesh(MeshConfig(data=2, model=2))
    rules = param_shardings(model, mesh, params)
    assert rules["output"]["w"].spec == P(None, "model")
    assert rules["output"]["b"].spec == P("model")
    assert rules["prefinal"]["big_w"].spec == P(None, "model")
    assert rules["prefinal"]["small_w"].spec == P("model", None)
    assert rules["linear1"]["w"].spec == P()


GRID_XCONFIG = f"""\
input name=input dim=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=16 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=16 big-dim=32
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""


def _setup_grid():
    """Grid-eligible flagship-shaped slice: a conv at the full->grid
    boundary (cut-conv candidate) + a stride-3 TDNN-F suffix, so the
    production grid path (dynamic supervision slice + strided cut-conv
    window) is actually exercised — sharded parity tests on a
    grid-INeligible model could silently no-op."""
    rng = np.random.default_rng(33)
    model = build_model_from_string(GRID_XCONFIG)
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=9), NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    csrs = [fst_to_csr(random_fst(rng, num_pdfs=NUM_PDFS, T=T_OUT,
                                  num_states=2 * (T_OUT + 1)))
            for _ in range(B)]
    num_graph = build_numerator_batch(csrs)
    batch = {
        "features": jnp.asarray(rng.normal(size=(B, T_IN, 8)).astype(np.float32)),
        "weights": jnp.ones(B, jnp.float32),
    }
    config = TrainConfig(learning_rate=0.01, momentum=0.5,
                         frame_subsampling_factor=STRIDE,
                         compute_dtype="float32", grid_subsample=True)
    return model, den, num_graph, batch, config


class TestGridSharded:
    """Grid + cut-conv under meshes: the frame-grid
    program — dynamic full->grid cut slice, strided cut-conv window, grid
    BN statistics — must reproduce single-device numbers when the batch
    AND the feature time axis are sharded."""

    def test_grid_path_active(self):
        from kaldi_fp16_tpu.models.network import conv_cut_layers, grid_layers
        model = build_model_from_string(GRID_XCONFIG)
        g = grid_layers(model, STRIDE)
        assert g, "grid must be non-empty or the sharded test no-ops"
        assert {"tdnnf2", "prefinal", "output"} <= g
        assert conv_cut_layers(model, STRIDE) == frozenset({"cnn1"})
        # geometry: n_grid >= n_out so the train step keeps the grid on
        assert (T_IN - STRIDE) // STRIDE + 1 >= T_OUT

    @pytest.mark.parametrize("mesh_cfg", [MeshConfig(data=2, seq=2, model=1),
                                          MeshConfig(data=2, seq=2, model=2),
                                          MeshConfig(data=4, model=2)])
    def test_grid_sharded_matches_single_device(self, mesh_cfg):
        model, den, num_graph, batch, config = _setup_grid()
        opts = ChainTrainingOpts()

        step1 = make_train_step(model, den, num_graph, opts, config,
                                num_frames_out=T_OUT, donate=False)
        params, net_state, opt_state, scale_state = init_train_state(
            model, jax.random.PRNGKey(0), config)
        rng = jax.random.PRNGKey(5)
        p1, ns1, os1, ss1, out1 = step1(params, net_state, opt_state,
                                        scale_state, batch, rng)

        mesh = make_mesh(mesh_cfg)
        pure = make_train_step(model, den, num_graph, opts, config,
                               num_frames_out=T_OUT, donate=False, jit=False)
        params2, net_state2, opt_state2, scale_state2 = init_train_state(
            model, jax.random.PRNGKey(0), config)
        sbatch = shard_batch(batch, mesh)
        sstep, placed = make_sharded_train_step(
            pure, mesh, model, params2, net_state2, opt_state2, scale_state2,
            sbatch)
        p2, ns2, os2, ss2, out2 = sstep(*placed, sbatch, rng)

        np.testing.assert_allclose(float(out1.loss), float(out2.loss),
                                   rtol=1e-5)
        for lname in p1:
            for pname in p1[lname]:
                np.testing.assert_allclose(
                    np.asarray(p1[lname][pname]), np.asarray(p2[lname][pname]),
                    rtol=2e-5, atol=1e-6,
                    err_msg=f"{lname}/{pname} mismatch under {mesh_cfg}")
        # grid-layer BN statistics (pool grid frames only) must agree
        leaves1, treedef1 = jax.tree_util.tree_flatten(ns1)
        leaves2, treedef2 = jax.tree_util.tree_flatten(ns2)
        assert treedef1 == treedef2
        for a, b in zip(leaves1, leaves2):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=5e-7,
                err_msg=f"net_state mismatch under {mesh_cfg}")

    def test_grid_vs_fullrate_differ(self):
        """Sanity: the grid program is actually a different program (grid
        BN stats), so the parity above is not vacuous."""
        from dataclasses import replace
        model, den, num_graph, batch, config = _setup_grid()
        opts = ChainTrainingOpts()
        params, net_state, opt_state, scale_state = init_train_state(
            model, jax.random.PRNGKey(0), config)
        rng = jax.random.PRNGKey(5)
        step_g = make_train_step(model, den, num_graph, opts, config,
                                 num_frames_out=T_OUT, donate=False)
        step_f = make_train_step(model, den, num_graph, opts,
                                 replace(config, grid_subsample=False),
                                 num_frames_out=T_OUT, donate=False)
        _, ns_g, _, _, out_g = step_g(params, net_state, opt_state,
                                      scale_state, batch, rng)
        _, ns_f, _, _, out_f = step_f(params, net_state, opt_state,
                                      scale_state, batch, rng)
        # train-mode BN pools grid frames only on the grid program, so the
        # accumulated statistics must differ from the full-rate program's
        flat_g = jax.tree_util.tree_leaves(ns_g)
        flat_f = jax.tree_util.tree_leaves(ns_f)
        assert any(not np.allclose(np.asarray(a), np.asarray(b))
                   for a, b in zip(flat_g, flat_f)), (
            "grid and full-rate programs produced identical BN state -- "
            "the grid path is not active")


def test_multi_step_stability():
    """Several sharded steps in a row keep improving the objective."""
    model, den, num_graph, batch, config = _setup()
    mesh = make_mesh(MeshConfig(data=4, model=2))
    pure = make_train_step(model, den, num_graph, ChainTrainingOpts(), config,
                           num_frames_out=T_OUT, donate=False, jit=False)
    params, net_state, opt_state, scale_state = init_train_state(
        model, jax.random.PRNGKey(0), config)
    sbatch = shard_batch(batch, mesh)
    sstep, placed = make_sharded_train_step(
        pure, mesh, model, params, net_state, opt_state, scale_state, sbatch)
    params, net_state, opt_state, scale_state = placed
    losses = []
    key = jax.random.PRNGKey(0)
    for _ in range(6):
        key, sub = jax.random.split(key)
        params, net_state, opt_state, scale_state, out = sstep(
            params, net_state, opt_state, scale_state, sbatch, sub)
        losses.append(float(out.loss))
    assert losses[-1] < losses[0], losses


def test_sharded_with_natural_gradient():
    """NG-SGD composes with the dp-sharded step: the Fisher states ride the
    optimizer state generically (review finding: they were dropped)."""
    model, den, num_graph, batch, config = _setup()
    from dataclasses import replace
    config = replace(config, natural_gradient=True, ng_rank_in=4,
                     ng_rank_out=4)
    opts = ChainTrainingOpts()
    mesh = make_mesh(MeshConfig(data=4, model=1))
    pure = make_train_step(model, den, num_graph, opts, config,
                           num_frames_out=T_OUT, donate=False, jit=False)
    params, net_state, opt_state, scale_state = init_train_state(
        model, jax.random.PRNGKey(0), config)
    assert "ng" in opt_state
    sbatch = shard_batch(batch, mesh)
    sstep, placed = make_sharded_train_step(
        pure, mesh, model, params, net_state, opt_state, scale_state, sbatch)
    p2, ns2, os2, ss2, out = sstep(*placed, sbatch, jax.random.PRNGKey(5))
    assert "ng" in os2
    assert np.isfinite(float(out.loss))
    # and it matches the unsharded NG step
    step1 = make_train_step(model, den, num_graph, opts, config,
                            num_frames_out=T_OUT, donate=False)
    p1, _, os1, _, out1 = step1(params, net_state, opt_state, scale_state,
                                batch, jax.random.PRNGKey(5))
    np.testing.assert_allclose(float(out1.loss), float(out.loss), rtol=1e-5)
    site = next(iter(os1["ng"]))
    np.testing.assert_allclose(np.asarray(os1["ng"][site]["in"].v),
                               np.asarray(os2["ng"][site]["in"].v),
                               rtol=1e-4, atol=1e-5)


class TestDataParallelDecode:
    """Meshed decoding: graph replicated, batch sharded over 'data' —
    results must be IDENTICAL to the unsharded decoder."""

    def _graph(self, seed=5):
        from kaldi_fp16_tpu.decode.graph import DecodingGraph
        from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
        rng = np.random.default_rng(seed)
        n, P_ = 30, 12
        states = [FstState() for _ in range(n)]
        for s in range(n):
            for _ in range(3):
                states[s].arcs.append(FstArc(
                    int(rng.integers(1, P_ + 1)),
                    float(rng.uniform(0, 2)),
                    int(rng.integers(0, n)),
                    olabel=int(rng.integers(0, 5))))
            if rng.uniform() < 0.4:
                states[s].final = float(rng.uniform(0, 1))
        states[0].final = 0.0
        return DecodingGraph.from_fst(Fst(start=0, states=states)), P_

    def test_viterbi_sharded_matches_unsharded(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g, P_ = self._graph()
        mesh = make_mesh(MeshConfig(data=8))
        rng = np.random.default_rng(33)
        ll = rng.normal(size=(8, 11, P_)).astype(np.float32)
        ref = SparseViterbiDecoder(g).decode_batch(ll)
        got = SparseViterbiDecoder(g, mesh=mesh).decode_batch(ll)
        for r, s in zip(ref, got):
            assert r["words"] == s["words"]
            assert r["alignment"] == s["alignment"]
            np.testing.assert_allclose(r["total_cost"], s["total_cost"],
                                       atol=1e-4)

    def test_viterbi_tree_sharded_matches_unsharded(self):
        """The tree-ELL kernels must shard over the batch exactly like
        the segment kernels (every [.., B] tensor inherits the data-axis
        sharding; the multi-level gathers are batch-independent)."""
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g, P_ = self._graph(seed=9)
        mesh = make_mesh(MeshConfig(data=8))
        rng = np.random.default_rng(45)
        ll = rng.normal(size=(8, 7, P_)).astype(np.float32)
        ref = SparseViterbiDecoder(g, layout="tree",
                                   tree_max_width=4).decode_batch(ll)
        got = SparseViterbiDecoder(g, layout="tree", tree_max_width=4,
                                   mesh=mesh).decode_batch(ll)
        for r, s in zip(ref, got):
            assert r["words"] == s["words"]
            assert r["alignment"] == s["alignment"]
            np.testing.assert_allclose(r["total_cost"], s["total_cost"],
                                       atol=1e-4)

    def test_windowed_streaming_sharded_matches_unsharded(self):
        """Data-parallel HCLG-style streaming: the windowed decoder's
        score front, backpointer window, and traceback walks all shard
        over the batch; commits and finalize must equal the unsharded
        run exactly (words, alignments, costs, commit boundaries)."""
        from kaldi_fp16_tpu.decode.streaming import (
            WindowedStreamingDecoder,
        )
        g, P_ = self._graph(seed=12)
        mesh = make_mesh(MeshConfig(data=8))
        rng = np.random.default_rng(50)
        T, C, W = 32, 8, 16
        ll = rng.normal(size=(8, T, P_)).astype(np.float32) * 3.0
        outs = []
        for m in (None, mesh):
            dec = WindowedStreamingDecoder(g, acoustic_scale=0.7,
                                           window=W, mesh=m)
            st = dec.init(8)
            for t0 in range(0, T, C):
                st = dec.feed(st, ll[:, t0:t0 + C])
            assert st.committed_frames > 0
            outs.append((st.committed_frames, dec.finalize(st)))
        assert outs[0][0] == outs[1][0]
        for r, s in zip(outs[0][1], outs[1][1]):
            assert r["words"] == s["words"]
            assert r["alignment"] == s["alignment"]
            np.testing.assert_allclose(r["total_cost"], s["total_cost"],
                                       atol=1e-4)

    def test_viterbi_bad_batch_raises(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
        g, P_ = self._graph()
        mesh = make_mesh(MeshConfig(data=8))
        dec = SparseViterbiDecoder(g, mesh=mesh)
        with pytest.raises(ValueError, match="divisible"):
            dec.decode_batch(np.zeros((3, 5, P_), np.float32))

    def test_lattice_sharded_matches_unsharded(self):
        from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
        g, P_ = self._graph(seed=6)
        mesh = make_mesh(MeshConfig(data=8))
        rng = np.random.default_rng(44)
        ll = rng.normal(size=(8, 9, P_)).astype(np.float32)
        ref = DeviceLatticeDecoder(g, lattice_beam=5.0).decode_batch(ll)
        got = DeviceLatticeDecoder(g, lattice_beam=5.0,
                                   mesh=mesh).decode_batch(ll)
        for r, s in zip(ref, got):
            ra = {(int(r.node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                  for a in r.arcs}
            sa = {(int(s.node_frame[a.src]), a.ilabel, a.olabel,
                   round(a.graph_cost, 4), round(a.acoustic_cost, 4))
                  for a in s.arcs}
            assert ra == sa


def test_sharded_structured_denominator():
    """The STRUCTURED denominator (the production path for phone-LM
    graphs) must produce identical numbers under dp sharding — its
    chain-layout transforms, [F, F] matmul, and posterior reduction all
    have to partition cleanly along the batch axis."""
    from kaldi_fp16_tpu.chain.graph import make_phone_lm_den_fst
    model, _, num_graph, batch, config = _setup()
    den_graph = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(num_pdfs=NUM_PDFS, num_phones=4,
                              states_per_phone=2, branching=3, seed=2),
        NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    assert den._structured is not None, \
        "phone-LM graph must route to the structured kernels"
    opts = ChainTrainingOpts()

    step1 = make_train_step(model, den, num_graph, opts, config,
                            num_frames_out=T_OUT, donate=False)
    params, net_state, opt_state, scale_state = init_train_state(
        model, jax.random.PRNGKey(0), config)
    rng = jax.random.PRNGKey(5)
    _, _, _, _, out1 = step1(params, net_state, opt_state, scale_state,
                             batch, rng)

    mesh = make_mesh(MeshConfig(data=4, model=2))
    pure = make_train_step(model, den, num_graph, opts, config,
                           num_frames_out=T_OUT, donate=False, jit=False)
    params2, net_state2, opt_state2, scale_state2 = init_train_state(
        model, jax.random.PRNGKey(0), config)
    sbatch = shard_batch(batch, mesh)
    sstep, placed = make_sharded_train_step(
        pure, mesh, model, params2, net_state2, opt_state2, scale_state2,
        sbatch)
    _, _, _, _, out2 = sstep(*placed, sbatch, rng)
    np.testing.assert_allclose(float(out1.loss), float(out2.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out1.den_logprob),
                               float(out2.den_logprob), rtol=1e-5)
