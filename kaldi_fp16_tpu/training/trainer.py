"""Trainer: the loop around the pure train step.

(ref: internal/nnet/train_step.go Trainer + scripts/train_cnn_tdnn.sh
hyperparameters: epochs 15, lr 1e-3 -> 1e-4 exponential, batch 64.)

Handles per-bucket step compilation (one jit per (T_in, fps) bucket),
exponential LR decay, metric aggregation, periodic checkpointing.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.graph import build_numerator_batch
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu.io.batch import ChainBatch
from kaldi_fp16_tpu.models.model import Model
from kaldi_fp16_tpu.training.train_step import (
    TrainConfig, TrainStepOutput, init_train_state, make_train_step,
)


def exponential_lr(initial: float, final: float, num_steps: int
                   ) -> Callable[[int], float]:
    """Kaldi-style exponential decay lr(t) = li * (lf/li)^(t/T)."""
    ratio = final / initial

    def lr(step: int) -> float:
        frac = min(step / max(num_steps, 1), 1.0)
        return initial * (ratio ** frac)
    return lr


@dataclass
class TrainerMetrics:
    steps: int = 0
    examples: int = 0
    total_objf: float = 0.0
    total_weight: float = 0.0
    total_xent: float = 0.0
    skipped_steps: int = 0
    step_seconds: float = 0.0
    history: List[Dict] = field(default_factory=list)

    @property
    def objf_per_frame(self) -> float:
        return self.total_objf / max(self.total_weight, 1e-9)


class Trainer:
    """Drives train steps over ChainBatches with per-bucket compiled steps."""

    def __init__(self, model: Model, den: DenominatorComputation,
                 config: TrainConfig = TrainConfig(),
                 chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 seed: int = 0,
                 fst_pad_states: int = 256, fst_pad_arcs: int = 512,
                 mesh=None):
        self.model = model
        self.den = den
        self.config = config
        self.chain_opts = chain_opts
        self.lr_schedule = lr_schedule
        self._metrics = TrainerMetrics()
        self._pending: List = []   # queued (device-scalar…, w_frames) rows
        self.fst_pad_states = fst_pad_states
        self.fst_pad_arcs = fst_pad_arcs
        self._steps: Dict = {}
        self._key = jax.random.PRNGKey(seed)
        (self.params, self.net_state, self.opt_state,
         self.scale_state) = init_train_state(model, jax.random.PRNGKey(seed),
                                              config)
        self.global_step = 0
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            self._data_n = mesh.shape["data"]
            self._dp = lambda v: jax.device_put(
                jnp.asarray(v), NamedSharding(
                    mesh, PartitionSpec("data",
                                        *([None] * (np.ndim(v) - 1)))))
            self.place_states()

    @property
    def rng_key(self) -> np.ndarray:
        """Current step-noise PRNG key (uint32[2]) — pass as
        DataPosition.rng_key when checkpointing so a resume REPLAYS the
        killed run's SpecAugment/dropout draws exactly."""
        return np.asarray(self._key, np.uint32)

    def restore(self, mgr, step=None):
        """Restore params/states from a CheckpointManager and commit
        them to the mesh (restored arrays arrive host-resident;
        assigning them WITHOUT re-placement would silently train
        single-device layouts).  Also restores the step-noise RNG key
        when the checkpoint recorded one (replay fidelity).  Returns
        the DataPosition."""
        (self.params, self.net_state, self.opt_state,
         self.scale_state, gstep, pos) = mgr.restore(
            step, self.params, self.net_state, self.opt_state,
            self.scale_state)
        self.global_step = gstep
        if pos.rng_key is not None:
            self._key = jnp.asarray(pos.rng_key, jnp.uint32)
        self.place_states()
        return pos

    def place_states(self) -> None:
        """Commit params/states to their dp+tp mesh shardings (wide
        heads split over 'model', everything else replicated).  Called
        at construction and MUST be re-called after assigning restored
        checkpoint arrays (which arrive host-resident and would
        otherwise silently train single-device layouts).  The jitted
        steps inherit layouts from these COMMITTED inputs, so the
        graph-in-args path needs no per-bucket in_shardings plumbing."""
        if self.mesh is None:
            return
        from kaldi_fp16_tpu.parallel.data_parallel import (
            param_shardings, _repl_like,
        )
        mesh = self.mesh
        p_shard = param_shardings(self.model, mesh, self.params)
        self.params = jax.device_put(self.params, p_shard)
        self.net_state = jax.device_put(self.net_state,
                                        _repl_like(self.net_state, mesh))
        self.opt_state = {
            k: jax.device_put(v, p_shard if k == "velocity"
                              else _repl_like(v, mesh))
            for k, v in self.opt_state.items()}
        self.scale_state = jax.device_put(
            self.scale_state, _repl_like(self.scale_state, mesh))

    def _step_fn(self, batch: ChainBatch):
        """One compiled step per bucket geometry.

        The numerator graph arrays are baked into the jitted function via
        closure; with fixed padding (fst_pad_*) the SHAPES are stable, but
        values change per batch — so the graph must be an argument, not a
        closure.  make_train_step closes over num_graph; to keep its shapes
        as traced arguments we rebuild a step that takes the graph arrays.
        """
        key = (batch.features.shape, batch.frames_per_seq,
               batch.num_graph.num_states, batch.num_graph.num_arcs)
        if key not in self._steps:
            step = _make_graph_arg_train_step(
                self.model, self.den, self.chain_opts, self.config,
                batch.frames_per_seq)
            self._steps[key] = step
        return self._steps[key]

    def _validate_geometry(self, batch: ChainBatch) -> None:
        # Validate the bucket geometry host-side BEFORE dispatch: inside the
        # jitted step left_context feeds a dynamic_slice whose out-of-range
        # start is silently CLAMPED by JAX, which would misalign supervision
        # frames with labels instead of failing (advisor finding).
        stride = self.config.frame_subsampling_factor
        T_in = batch.features.shape[1]
        need = int(batch.left_context) + (batch.frames_per_seq - 1) * stride + 1
        if batch.left_context < 0 or need > T_in:
            raise ValueError(
                f"bad bucket geometry: left_context={batch.left_context} + "
                f"(n_out={batch.frames_per_seq}-1)*stride={stride}+1 needs "
                f"{need} input frames but features have T_in={T_in}; the "
                "dynamic supervision slice would be silently clamped")
        if self.mesh is not None and batch.batch_size % self._data_n:
            raise ValueError(
                f"batch {batch.batch_size} not divisible by data-axis "
                f"size {self._data_n} (pad or drop the remainder batch)")

    def place_batch(self, batch: ChainBatch):
        """Upload a batch's arrays to their device/mesh placement WITHOUT
        dispatching a step.  Exposed so a driver loop can double-buffer:
        upload batch i+1 while step i is still executing (device_put is
        async, so the host-to-device transfer overlaps the step)."""
        self._validate_geometry(batch)
        g = batch.num_graph
        put = self._dp if self.mesh is not None else jnp.asarray
        arrays = {k: put(v) for k, v in batch.arrays().items()}
        if batch.deriv_weights is not None:
            arrays["deriv_weights"] = put(batch.deriv_weights)
        graph_args = (put(g.arc_src), put(g.arc_dst), put(g.arc_pdf),
                      put(g.arc_logw), put(g.arc_mask), put(g.start),
                      put(g.final_logw))
        return arrays, graph_args

    def train_batch(self, batch: ChainBatch, placed=None) -> TrainStepOutput:
        """Dispatch one train step.  FULLY ASYNC: no host<->device sync —
        metrics accumulate as device scalars and are fetched in one
        transfer when .metrics is read (a per-step float() sync would
        stall the host on every step).
        `placed`: pre-uploaded (arrays, graph_args) from place_batch."""
        if placed is None:
            placed = self.place_batch(batch)
        else:
            self._validate_geometry(batch)
        step = self._step_fn(batch)
        self._key, sub = jax.random.split(self._key)
        t0 = time.perf_counter()
        (self.params, self.net_state, self.opt_state, self.scale_state,
         out) = step(*self._step_args(batch, placed, sub))
        dt = time.perf_counter() - t0

        self.global_step += 1
        m = self._metrics
        m.steps += 1
        m.examples += batch.batch_size
        # chain objective ONLY (out.loss also folds in the xent regularizer,
        # which would overstate chain progress in epoch logs); device
        # scalars queue here and are fetched lazily in one batch
        w_frames = float(np.sum(batch.weights)) * batch.frames_per_seq
        self._pending.append(
            (out.objf_per_frame, out.xent_objf, out.skipped, w_frames))
        m.step_seconds += dt   # dispatch wall-time; device time shows up
        #                        in whoever syncs (flush / epoch end)
        return out

    def _step_args(self, batch: ChainBatch, placed, key):
        arrays, graph_args = placed
        lr = (self.lr_schedule(self.global_step) if self.lr_schedule
              else self.config.learning_rate)
        return (self.params, self.net_state, self.opt_state,
                self.scale_state, arrays, *graph_args, key,
                jnp.asarray(lr, jnp.float32),
                jnp.asarray(batch.left_context, jnp.int32))

    def lower_step(self, batch: ChainBatch, placed=None):
        """The `jax.stages.Lowered` of the step `train_batch(batch)` would
        run next, for inspection: `.compile()` gives its memory and cost
        analysis and its HLO.  Dispatches nothing and changes no state."""
        if placed is None:
            placed = self.place_batch(batch)
        return self._step_fn(batch).lower(
            *self._step_args(batch, placed, self._key))

    def _flush_pending(self) -> None:
        """Drain queued per-step device scalars into the host metrics in
        ONE device_get (this is the only sync point metrics cost)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        vals = jax.device_get([p[:3] for p in pending])
        m = self._metrics
        for (objf_pf, xent, skipped), (_, _, _, w_frames) in zip(
                vals, pending):
            m.total_objf += float(objf_pf) * w_frames
            m.total_weight += w_frames
            m.total_xent += float(xent)
            m.skipped_steps += int(bool(skipped))

    @property
    def metrics(self) -> TrainerMetrics:
        self._flush_pending()
        return self._metrics

    def eval_batch(self, batch: ChainBatch):
        """Held-out diagnostic on one batch (compute_prob analog): eval
        -mode forward + chain objf, no updates.  Returns the device
        EvalStepOutput (async — stack them and device_get in bulk)."""
        self._validate_geometry(batch)
        key = ("eval", batch.features.shape, batch.frames_per_seq,
               batch.num_graph.num_states, batch.num_graph.num_arcs)
        if key not in self._steps:
            from kaldi_fp16_tpu.training.train_step import make_eval_step
            self._steps[key] = make_eval_step(
                self.model, self.den, self.chain_opts, self.config,
                num_frames_out=batch.frames_per_seq)
        arrays, graph_args = self.place_batch(batch)
        return self._steps[key](self.params, self.net_state, arrays,
                                *graph_args,
                                jnp.asarray(batch.left_context, jnp.int32))

    def eval_epoch(self, batches):
        """Weighted objf/frame + xent over a held-out set (one pass).
        Returns dict(objf_per_frame, num_logprob, den_logprob,
        xent_objf, frames, batches) — the per-epoch 'valid' diagnostic
        line Kaldi prints from compute_prob_valid.*.log."""
        outs = [self.eval_batch(b) for b in batches]
        if not outs:
            return None
        vals = jax.device_get([(o.objf_per_frame, o.num_logprob,
                                o.den_logprob, o.xent_objf,
                                o.weight_frames) for o in outs])
        tot_w = sum(float(v[4]) for v in vals)
        if tot_w == 0:
            return None
        # num/den carry the same weight_frames weighting as objf so the
        # reported decomposition moves consistently with objf_per_frame
        # (unweighted batch means would misattribute objf movement when
        # batches differ in frames or supervision weight); xent_objf is
        # a per-batch TOTAL (train_step sums weights*posts*xent), so the
        # epoch aggregate is a plain sum.
        return {
            "objf_per_frame": sum(float(v[0]) * float(v[4])
                                  for v in vals) / tot_w,
            "num_logprob": sum(float(v[1]) * float(v[4])
                               for v in vals) / tot_w,
            "den_logprob": sum(float(v[2]) * float(v[4])
                               for v in vals) / tot_w,
            "xent_objf": float(np.sum([v[3] for v in vals])),
            "frames": tot_w,
            "batches": len(vals),
        }

    def train_epoch(self, batches, log_every: int = 0,
                    log_fn=print) -> TrainerMetrics:
        """Pipelined epoch loop: batch i+1 is uploaded (device_put, async)
        while step i executes, and the host only syncs on the log cadence."""
        it = iter(batches)
        nxt = next(it, None)
        placed = self.place_batch(nxt) if nxt is not None else None
        i = 0
        while nxt is not None:
            batch, cur = nxt, placed
            nxt = next(it, None)
            out = self.train_batch(batch, placed=cur)
            # upload the NEXT batch while the step above is in flight
            placed = self.place_batch(nxt) if nxt is not None else None
            i += 1
            if log_every and i % log_every == 0:
                log_fn(f"step {self.global_step}: loss={float(out.loss):.4f} "
                       f"objf/frame={float(out.objf_per_frame):.4f} "
                       f"num={float(out.num_logprob):.4f} "
                       f"den={float(out.den_logprob):.4f} "
                       f"|dW|={float(out.param_change_norm):.4f}")
        return self.metrics


def _make_graph_arg_train_step(model, den, chain_opts, config,
                               num_frames_out: int):
    """Thin wrapper: the unified train step (train_step.make_train_step)
    with the numerator-graph arrays as traced arguments so one compilation
    serves every batch of the same bucket geometry.  Donates params and
    optimizer state like the static-graph path."""
    step = make_train_step(model, den, None, chain_opts, config,
                           num_frames_out=num_frames_out, jit=False,
                           graph_in_args=True)
    return jax.jit(step, donate_argnums=(0, 2))
