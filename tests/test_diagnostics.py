"""Held-out diagnostics (compute_prob analog) + final-model averaging.

Kaldi's training ops staples the reference relied on Kaldi itself for:
per-iteration valid objf via
nnet3-chain-compute-prob (the BASELINE.md trained-model objf
~-0.17/frame comes from those logs) and final-model combination over
the last N iterates.  Pinned here:

  * make_eval_step: eval-mode forward (BN running stats, no augment),
    finite objf, deterministic, pure (params/state untouched),
  * Trainer.eval_epoch: weighted aggregation over batches,
  * checkpoint averaging: mean of the last-N params via
    CheckpointManager.all_steps + restore.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.graph import (
    DenominatorGraph, build_numerator_batch, make_simple_den_fst,
)
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu.models.model import build_model_from_string
from kaldi_fp16_tpu.training.train_step import (
    TrainConfig, init_train_state, make_eval_step, make_train_step,
)
from tests.test_chain_numerator import random_fst

NUM_PDFS = 8
T_IN, T_OUT, STRIDE = 12, 4, 3
B = 4

XCONFIG = f"""\
input name=input dim=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=16 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=16 big-dim=32
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""


def _setup():
    rng = np.random.default_rng(7)
    model = build_model_from_string(XCONFIG)
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=3),
        NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    csrs = [fst_to_csr(random_fst(rng, num_pdfs=NUM_PDFS, T=T_OUT,
                                  num_states=2 * (T_OUT + 1)))
            for _ in range(B)]
    num_graph = build_numerator_batch(csrs)
    batch = {
        "features": jnp.asarray(
            rng.normal(size=(B, T_IN, 8)).astype(np.float32)),
        "weights": jnp.ones(B, jnp.float32),
    }
    config = TrainConfig(learning_rate=0.01, compute_dtype="float32")
    return model, den, num_graph, batch, config


def _graph_args(g):
    return (g.arc_src, g.arc_dst, g.arc_pdf, g.arc_logw, g.arc_mask,
            g.start, g.final_logw)


class TestEvalStep:
    def test_finite_and_deterministic(self):
        model, den, num_graph, batch, config = _setup()
        params, net_state, *_ = init_train_state(
            model, jax.random.PRNGKey(0), config)
        step = make_eval_step(model, den, ChainTrainingOpts(), config,
                              num_frames_out=T_OUT)
        lc = jnp.asarray(0, jnp.int32)
        o1 = step(params, net_state, batch, *_graph_args(num_graph), lc)
        o2 = step(params, net_state, batch, *_graph_args(num_graph), lc)
        assert np.isfinite(float(o1.objf_per_frame))
        assert float(o1.objf_per_frame) == float(o2.objf_per_frame)
        assert float(o1.weight_frames) == B * T_OUT
        assert bool(o1.ok)

    def test_eval_uses_running_stats_not_batch_stats(self):
        """compute-prob semantics: batchnorm-test-mode=true.  After a
        train step changes the BN running stats, the eval objf must
        change too (it reads net_state), while two evals with the SAME
        state are identical (no stats accumulation during eval)."""
        model, den, num_graph, batch, config = _setup()
        params, net_state, opt_state, scale_state = init_train_state(
            model, jax.random.PRNGKey(0), config)
        ev = make_eval_step(model, den, ChainTrainingOpts(), config,
                            num_frames_out=T_OUT)
        lc = jnp.asarray(0, jnp.int32)
        before = float(ev(params, net_state, batch,
                          *_graph_args(num_graph), lc).objf_per_frame)
        tr = make_train_step(model, den, num_graph, ChainTrainingOpts(),
                             config, num_frames_out=T_OUT, donate=False)
        _, ns2, _, _, _ = tr(params, net_state, opt_state, scale_state,
                             batch, jax.random.PRNGKey(1))
        after = float(ev(params, ns2, batch,
                         *_graph_args(num_graph), lc).objf_per_frame)
        assert before != after, (
            "eval objf ignored the BN running stats -> it is not "
            "running in test mode")

    def test_trainer_eval_epoch(self):
        from kaldi_fp16_tpu.io.batch import ChainBatch
        model, den, num_graph, batch, config = _setup()
        from kaldi_fp16_tpu.training.trainer import Trainer
        trainer = Trainer(model, den, config, ChainTrainingOpts(),
                          fst_pad_states=num_graph.num_states,
                          fst_pad_arcs=num_graph.num_arcs)
        cb = ChainBatch(
            features=np.asarray(batch["features"]),
            ivectors=None,
            weights=np.asarray(batch["weights"]),
            num_graph=num_graph, frames_per_seq=T_OUT, left_context=0,
            deriv_weights=None, keys=["a", "b", "c", "d"])
        res = trainer.eval_epoch([cb, cb])
        assert res is not None
        assert res["batches"] == 2
        assert res["frames"] == 2 * B * T_OUT
        assert np.isfinite(res["objf_per_frame"])
        # eval must not advance training state
        assert trainer.global_step == 0


class TestCheckpointAveraging:
    def test_mean_of_last_n(self, tmp_path):
        from kaldi_fp16_tpu.training.checkpoint import (
            CheckpointManager, DataPosition,
        )
        model, den, num_graph, batch, config = _setup()
        params, net_state, opt_state, scale_state = init_train_state(
            model, jax.random.PRNGKey(0), config)
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
        for step, fill in ((1, 1.0), (2, 2.0), (3, 6.0)):
            p = jax.tree_util.tree_map(
                lambda a, f=fill: jnp.full_like(a, f), params)
            mgr.save(step, p, net_state, opt_state, scale_state,
                     DataPosition())
        steps = mgr.all_steps()
        assert steps == [1, 2, 3]
        last2 = steps[-2:]
        acc = None
        for s in last2:
            p_s = mgr.restore(s, params, net_state, opt_state,
                              scale_state)[0]
            acc = (p_s if acc is None else jax.tree_util.tree_map(
                lambda a, b: a + b, acc, p_s))
        avg = jax.tree_util.tree_map(
            lambda a: (a / len(last2)).astype(a.dtype), acc)
        leaf = jax.tree_util.tree_leaves(avg)[0]
        np.testing.assert_allclose(np.asarray(leaf),
                                   np.full_like(np.asarray(leaf), 4.0))
        mgr.close()
