"""The pure, jittable training step (ref: internal/nnet/train_step.go).

Pipeline per step, mirroring Kaldi NnetChainTrainer::TrainInternal:
  features/ivectors -> Network.forward (bf16 compute)
  -> subsample output frames (stride 3, left-context offset)
  -> chain objective (custom_vjp: analytic forward-backward derivative)
  [+ optional xent head: xent_regularize * sum(num_post * log_softmax)]
  -> jax.grad through the whole thing
  -> dynamic loss scale bookkeeping
  -> SGD with momentum, fp32 master weights, per-component + global
     max-change clipping

Everything is a pure function (params, state, opt, batch) -> new values, so
it shards transparently under pjit/shard_map (see parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain.graph import NumeratorGraphBatch
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.objective import (
    ChainResult, ChainTrainingOpts, make_chain_objf_with_post,
)
from kaldi_fp16_tpu.models.model import Model
from kaldi_fp16_tpu.models.network import (
    forward, grid_layers, make_ng_taps, ng_sites, subsample_output,
    trainable_mask,
)
from kaldi_fp16_tpu.training.natural_gradient import (
    NGConfig, init_ng_state, ng_update, precondition_grad,
)
from kaldi_fp16_tpu.training.optimizer import (
    SGDConfig, init_sgd_state, layer_hyperparams, sgd_update,
)
from kaldi_fp16_tpu.training.orthonormal import (
    constrain_orthonormal, orthonormal_targets,
)
from kaldi_fp16_tpu.training.loss_scale import (
    LossScaleState, grads_finite, init_loss_scale, unscale_grads,
    update_loss_scale,
)


@dataclass(frozen=True)
class TrainConfig:
    """(ref: TrainConfig train_step.go:21-28 + ChainTrainingOpts)."""
    learning_rate: float = 1e-3
    momentum: float = 0.0
    max_param_change: float = 2.0
    frame_subsampling_factor: int = 3
    left_context: int = 0          # row offset of the first supervised frame
    xent_regularize: float = 0.0
    use_loss_scaling: bool = False
    compute_dtype: str = "bfloat16"
    # Kaldi NG-SGD: precondition every affine gradient with online low-rank
    # Fisher estimates of the matmul inputs / output derivatives
    # (training/natural_gradient.py); ranks follow Kaldi defaults.
    natural_gradient: bool = False
    ng_rank_in: int = 20
    ng_rank_out: int = 80
    # rematerialize the network forward in the backward pass (jax.checkpoint)
    # — trades ~1 extra forward for not storing activations, buying batch
    # size / sequence length headroom in HBM
    remat: bool = False
    # apply the Kaldi semi-orthogonal constraint to tdnnf/prefinal
    # bottleneck linears every N non-skipped steps (0 disables; Kaldi
    # uses a random ~1/4 of steps — training/orthonormal.py)
    orthonormal_interval: int = 4
    # run grid-eligible layers (post-CNN stack in the flagship) only at
    # the chain-supervision frame rate — the nnet3 computation-compiler
    # optimization (models/network.py grid_layers); ~3x less compute for
    # those layers.  Grid-layer BN stats then accumulate over grid
    # frames, matching real Kaldi's compiled computation.
    grid_subsample: bool = True


class TrainStepOutput(NamedTuple):
    loss: jnp.ndarray
    objf_per_frame: jnp.ndarray
    num_logprob: jnp.ndarray
    den_logprob: jnp.ndarray
    xent_objf: jnp.ndarray
    param_change_norm: jnp.ndarray
    grad_norm: jnp.ndarray
    loss_scale: jnp.ndarray
    skipped: jnp.ndarray
    ok: jnp.ndarray



def apply_natural_gradient(sites, ng_states, xs, tap_grads, grads, skip,
                           cfg_in: NGConfig, cfg_out: NGConfig):
    """Kaldi NG-SGD: update the online Fisher factors from this batch's
    matmul inputs X and output-derivatives G, then precondition the
    accumulated gradient on both sides:
        dW_ext <- gamma * P_in^-1 [dW; db] P_out^-1
    (the factorization through dW = X^T G makes per-sample preconditioning
    unnecessary — natural_gradient.py docstring).  On skip (non-finite
    batch) the Fisher states are left untouched.

    Returns (preconditioned grads, new ng states)."""
    grads = {k: dict(v) for k, v in grads.items()}
    new_ng = {}
    for site in sites:
        nm = site["name"]
        x_site = xs[nm].astype(jnp.float32)
        g_site = tap_grads[nm].astype(jnp.float32)
        x2 = x_site.reshape(-1, x_site.shape[-1])
        g2 = g_site.reshape(-1, g_site.shape[-1])
        if site["b"] is not None:
            x2 = jnp.concatenate(
                [x2, jnp.ones((x2.shape[0], 1), jnp.float32)], 1)
        st_in = ng_update(ng_states[nm]["in"], x2, cfg_in)
        st_out = ng_update(ng_states[nm]["out"], g2, cfg_out)
        st_in = jax.tree_util.tree_map(
            lambda a, b: jnp.where(skip, b, a), st_in, ng_states[nm]["in"])
        st_out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(skip, b, a), st_out, ng_states[nm]["out"])
        new_ng[nm] = {"in": st_in, "out": st_out}
        dw = grads[site["layer"]][site["w"]].astype(jnp.float32)
        if site["b"] is not None:
            db = grads[site["layer"]][site["b"]].astype(jnp.float32)
            dwe = jnp.concatenate([dw, db[None, :]], axis=0)
        else:
            dwe = dw
        dwe = precondition_grad(st_in, st_out, dwe, cfg_in)
        if site["b"] is not None:
            grads[site["layer"]][site["w"]] = dwe[:-1]
            grads[site["layer"]][site["b"]] = dwe[-1]
        else:
            grads[site["layer"]][site["w"]] = dwe
    return grads, new_ng


def make_train_step(model: Model,
                    den: DenominatorComputation,
                    num_graph: Optional[NumeratorGraphBatch],
                    chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                    config: TrainConfig = TrainConfig(),
                    num_frames_out: Optional[int] = None,
                    donate: bool = True,
                    jit: bool = True,
                    graph_in_args: bool = False):
    """Build a jitted train_step for a fixed (bucketed) batch geometry.

    num_frames_out: supervision frames per sequence (shared across the
    bucket); default infers from T and subsampling on first call.

    graph_in_args=False (default): the numerator graph is baked into the
    step via closure; step(params, net_state, opt_state, scale_state,
    batch, rng, lr=None).

    graph_in_args=True (the Trainer path): the numerator-graph ARRAYS are
    traced arguments so one compilation serves every batch of a bucket
    geometry, and the subsample offset is a traced left_context:
    step(params, net_state, opt_state, scale_state, batch,
         arc_src, arc_dst, arc_pdf, arc_logw, arc_mask, start, final_logw,
         rng, lr, left_context).

    Per-frame supervision deriv_weights ([B, n_out] in batch
    ["deriv_weights"], optional) mask the chain derivative AND the xent
    head (Kaldi semantics).
    """
    if not graph_in_args:
        assert num_graph is not None
        static_objf_fn = make_chain_objf_with_post(num_graph, den, chain_opts)
    hyper = layer_hyperparams(model)
    sites = ng_sites(model) if config.natural_gradient else []
    ng_cfg_in = NGConfig(rank=config.ng_rank_in)
    ng_cfg_out = NGConfig(rank=config.ng_rank_out)
    dtype = jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32
    # two spellings of the Kaldi option exist (TrainConfig mirrors
    # TrainConfig/train_step.go, ChainTrainingOpts mirrors backward.go);
    # honor whichever is set so neither knob is silently dead
    xent_regularize = config.xent_regularize or chain_opts.xent_regularize
    sgd_cfg = SGDConfig(learning_rate=config.learning_rate,
                        momentum=config.momentum,
                        max_param_change=config.max_param_change)

    def step_body(params, net_state, opt_state, scale_state: LossScaleState,
                  batch: Dict[str, jnp.ndarray], rng, lr, objf_fn,
                  left_context):
        feats = batch["features"]            # [B, T_in, D]
        ivecs = batch.get("ivectors")        # [B, ivec]
        weights = batch.get("weights")       # [B]
        dws = batch.get("deriv_weights")     # [B, n_out] or None
        B, T_in, _ = feats.shape
        stride = config.frame_subsampling_factor
        n_out = num_frames_out or (T_in - config.left_context + stride - 1) // stride
        if weights is None:
            weights = jnp.ones(B, jnp.float32)
        dws_arg = (jnp.ones((B, n_out), jnp.float32) if dws is None
                   else dws.astype(jnp.float32))

        # frame-grid subsampling (nnet3-compiler equivalent): run the
        # grid-eligible suffix of the network only at frames
        # {left_context % stride + k*stride}; output heads then come back
        # already on the grid and pick_frames is a unit-stride slice.
        grid = (grid_layers(model, stride) if config.grid_subsample
                else frozenset())
        chain_head_name = model.chain_output().name
        use_grid = chain_head_name in grid
        n_grid = (T_in - stride) // stride + 1 if use_grid else 0
        if use_grid and n_out > n_grid:
            # degenerate geometry (chunk shorter than the supervision
            # span): fall back to the full-rate program rather than let
            # dynamic_slice clamp the pick silently
            use_grid, grid, n_grid = False, frozenset(), 0
        time_subsample = ((stride, left_context % stride, n_grid)
                          if use_grid else None)

        def pick_frames(full, on_grid=False):
            """Supervision frames: rows left_context, +stride, ... — via
            dynamic slice so left_context may be a traced value.  Grid
            outputs hold only grid frames, so the pick is a unit-stride
            slice at grid index left_context // stride."""
            if on_grid:
                return jax.lax.dynamic_slice_in_dim(
                    full, left_context // stride, n_out, axis=1)
            sl = jax.lax.dynamic_slice_in_dim(
                full, left_context, (n_out - 1) * stride + 1, axis=1)
            return sl[:, ::stride]

        def net_apply(p, taps):
            if taps is not None:
                return forward(
                    model, p, net_state, feats, ivecs, train=True, rng=rng,
                    compute_dtype=dtype, ng_taps=taps, collect_ng=True,
                    time_subsample=time_subsample)
            outs, new_state = forward(model, p, net_state, feats, ivecs,
                                      train=True, rng=rng,
                                      compute_dtype=dtype,
                                      time_subsample=time_subsample)
            return outs, new_state, {}

        if config.remat:
            net_apply = jax.checkpoint(net_apply)

        def loss_fn(p, taps):
            outs, new_state, xs = net_apply(p, taps)
            out = pick_frames(outs[chain_head_name].astype(jnp.float32),
                              on_grid=use_grid)
            objf, result, num_post = objf_fn(out, weights, dws_arg)
            loss = -objf
            xent_objf = jnp.zeros((), jnp.float32)
            xent_layer = model.xent_output()
            if xent_regularize > 0 and xent_layer is not None:
                xent = pick_frames(outs[xent_layer.name].astype(jnp.float32),
                                   on_grid=xent_layer.name in grid)
                xent = xent * dws_arg[:, :, None]
                xent_objf = jnp.sum(weights[:, None, None] * num_post * xent)
                loss = loss - xent_regularize * xent_objf
            if config.use_loss_scaling:
                loss = loss * scale_state.scale
            return loss, (result, new_state, xent_objf, xs)

        if config.natural_gradient:
            taps = make_ng_taps(sites, B, T_in, grid=grid, n_grid=n_grid)
            ((loss, (result, new_state, xent_objf, xs)),
             (grads, tap_grads)) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(params, taps)
        else:
            (loss, (result, new_state, xent_objf, xs)), grads = (
                jax.value_and_grad(loss_fn, has_aux=True)(params, None))
            tap_grads = {}

        if config.use_loss_scaling:
            loss = loss / scale_state.scale
            grads = unscale_grads(grads, scale_state)
            if config.natural_gradient:
                tap_grads = unscale_grads(tap_grads, scale_state)

        # finiteness is judged on the RAW grads; a non-finite batch must
        # neither update the NG Fisher stats nor the weights
        finite = grads_finite(grads)
        if config.use_loss_scaling:
            new_scale_state, skip = update_loss_scale(scale_state, finite)
        else:
            # no silent scale drift when scaling is off (the schedule would
            # otherwise double the nominal 1.0 scale every growth interval)
            new_scale_state, skip = scale_state, ~finite

        new_ng = opt_state.get("ng", {})
        if config.natural_gradient:
            grads, new_ng = apply_natural_gradient(
                sites, opt_state["ng"], xs, tap_grads, grads, skip,
                ng_cfg_in, ng_cfg_out)
        grad_norm = jnp.sqrt(sum(
            jnp.sum(g.astype(jnp.float32) ** 2)
            for g in jax.tree_util.tree_leaves(grads)))

        # a skipped (non-finite) batch must not poison BN running stats
        # either — Inf activations would flow into eval-mode forwards
        new_state = jax.tree_util.tree_map(
            lambda new, old: jnp.where(skip, old, new), new_state, net_state)

        mask = trainable_mask(model, params)
        new_params, new_opt_state, stats = sgd_update(
            params, grads, {k: v for k, v in opt_state.items() if k != "ng"},
            sgd_cfg, lr=lr, hyper=hyper, trainable=mask, skip=skip)
        if config.natural_gradient:
            new_opt_state["ng"] = new_ng

        # Kaldi applies ConstrainOrthonormal after the parameter update
        # (nnet-chain-training.cc TrainInternal -> ConstrainOrthonormal)
        if config.orthonormal_interval > 0:
            targets = orthonormal_targets(model)
            if targets:
                do = ((new_opt_state["step"] % config.orthonormal_interval
                       == 0) & ~skip)
                for lname, pname, c in targets:
                    w = new_params[lname][pname]
                    new_params[lname] = dict(
                        new_params[lname],
                        **{pname: jax.lax.cond(
                            do,
                            lambda w, _c=c: constrain_orthonormal(w, _c),
                            lambda w: w, w)})

        out = TrainStepOutput(
            loss=loss,
            objf_per_frame=result.objf_per_frame,
            num_logprob=result.num_logprob.mean(),
            den_logprob=result.den_logprob.mean(),
            xent_objf=xent_objf,
            param_change_norm=stats["param_change_norm"],
            grad_norm=grad_norm,
            loss_scale=new_scale_state.scale,
            skipped=skip,
            ok=result.ok.all(),
        )
        return new_params, new_state, new_opt_state, new_scale_state, out

    if graph_in_args:
        from kaldi_fp16_tpu.chain.graph import NumeratorGraphBatch as _NGB

        def step(params, net_state, opt_state, scale_state, batch,
                 arc_src, arc_dst, arc_pdf, arc_logw, arc_mask, start,
                 final_logw, rng, lr, left_context):
            g = _NGB(arc_src=arc_src, arc_dst=arc_dst, arc_pdf=arc_pdf,
                     arc_logw=arc_logw, arc_mask=arc_mask, start=start,
                     final_logw=final_logw,
                     num_states=final_logw.shape[1],
                     num_arcs=arc_src.shape[1])
            objf_fn = make_chain_objf_with_post(g, den, chain_opts)
            return step_body(params, net_state, opt_state, scale_state,
                             batch, rng, lr, objf_fn, left_context)
    else:
        def step(params, net_state, opt_state, scale_state, batch, rng,
                 lr=None):
            return step_body(params, net_state, opt_state, scale_state,
                             batch, rng, lr, static_objf_fn,
                             config.left_context)

    if not jit:
        return step  # pure function, for re-jitting with explicit shardings
    donate_argnums = (0, 2) if donate else ()
    return jax.jit(step, donate_argnums=donate_argnums)


def init_train_state(model: Model, key, config: TrainConfig = TrainConfig()):
    """(params, net_state, opt_state, loss_scale_state)."""
    from kaldi_fp16_tpu.models.network import init_params
    params, net_state = init_params(model, key)
    opt_state = init_sgd_state(params)
    if config.natural_gradient:
        opt_state["ng"] = {}
        for site in ng_sites(model):
            d_in = site["in_dim"] + (1 if site["b"] is not None else 0)
            opt_state["ng"][site["name"]] = {
                "in": init_ng_state(d_in, NGConfig(rank=config.ng_rank_in)),
                "out": init_ng_state(site["out_dim"],
                                     NGConfig(rank=config.ng_rank_out)),
            }
    scale_state = init_loss_scale() if config.use_loss_scaling else init_loss_scale(1.0)
    return params, net_state, opt_state, scale_state


class EvalStepOutput(NamedTuple):
    objf_per_frame: jnp.ndarray
    num_logprob: jnp.ndarray
    den_logprob: jnp.ndarray
    xent_objf: jnp.ndarray
    weight_frames: jnp.ndarray
    ok: jnp.ndarray


def make_eval_step(model: Model,
                   den: DenominatorComputation,
                   chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                   config: TrainConfig = TrainConfig(),
                   num_frames_out: Optional[int] = None,
                   jit: bool = True):
    """Held-out diagnostic step — the `nnet3-chain-compute-prob` analog
    (Kaldi's training recipes run it per iteration on train_diagnostic
    and valid_diagnostic egs; the reference had no equivalent — its
    trained-model objf baseline ~-0.17/frame in BASELINE.md came from
    Kaldi's own compute_prob logs).

    Forward runs in EVAL mode: BatchNorm uses accumulated (running)
    stats and SpecAugment/dropout are off — matching compute-prob's
    defaults `--batchnorm-test-mode=true --dropout-test-mode=true`
    (kaldi nnet3-chain-compute-prob.cc).  No derivative, no state or
    parameter updates.  Graph-in-args like the Trainer's train step so
    one compilation serves every batch of a bucket geometry.

    step(params, net_state, batch, arc_src, arc_dst, arc_pdf, arc_logw,
         arc_mask, start, final_logw, left_context) -> EvalStepOutput
    """
    dtype = jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32
    xent_regularize = config.xent_regularize or chain_opts.xent_regularize

    def step(params, net_state, batch, arc_src, arc_dst, arc_pdf,
             arc_logw, arc_mask, start, final_logw, left_context):
        g = NumeratorGraphBatch(
            arc_src=arc_src, arc_dst=arc_dst, arc_pdf=arc_pdf,
            arc_logw=arc_logw, arc_mask=arc_mask, start=start,
            final_logw=final_logw, num_states=final_logw.shape[1],
            num_arcs=arc_src.shape[1])
        objf_fn = make_chain_objf_with_post(g, den, chain_opts)

        feats = batch["features"]
        ivecs = batch.get("ivectors")
        weights = batch.get("weights")
        dws = batch.get("deriv_weights")
        B, T_in, _ = feats.shape
        stride = config.frame_subsampling_factor
        n_out = num_frames_out or (
            T_in - config.left_context + stride - 1) // stride
        if weights is None:
            weights = jnp.ones(B, jnp.float32)
        dws_arg = (jnp.ones((B, n_out), jnp.float32) if dws is None
                   else dws.astype(jnp.float32))

        # same frame-grid geometry as the train step (train_step.py
        # step_body); in eval mode interior grid frames are bit-equal to
        # the full-rate program (tests/test_grid_subsample.py)
        grid = (grid_layers(model, stride) if config.grid_subsample
                else frozenset())
        chain_head_name = model.chain_output().name
        use_grid = chain_head_name in grid
        n_grid = (T_in - stride) // stride + 1 if use_grid else 0
        if use_grid and n_out > n_grid:
            use_grid, grid, n_grid = False, frozenset(), 0
        time_subsample = ((stride, left_context % stride, n_grid)
                          if use_grid else None)

        def pick_frames(full, on_grid=False):
            if on_grid:
                return jax.lax.dynamic_slice_in_dim(
                    full, left_context // stride, n_out, axis=1)
            sl = jax.lax.dynamic_slice_in_dim(
                full, left_context, (n_out - 1) * stride + 1, axis=1)
            return sl[:, ::stride]

        outs, _ = forward(model, params, net_state, feats, ivecs,
                          train=False, compute_dtype=dtype,
                          time_subsample=time_subsample)
        out = pick_frames(outs[chain_head_name].astype(jnp.float32),
                          on_grid=use_grid)
        objf, result, num_post = objf_fn(out, weights, dws_arg)

        xent_objf = jnp.zeros((), jnp.float32)
        xent_layer = model.xent_output()
        if xent_regularize > 0 and xent_layer is not None:
            xent = pick_frames(outs[xent_layer.name].astype(jnp.float32),
                               on_grid=xent_layer.name in grid)
            xent = xent * dws_arg[:, :, None]
            xent_objf = jnp.sum(weights[:, None, None] * num_post * xent)

        w_frames = jnp.sum(weights) * n_out
        # num/den weighted by the SAME per-sequence weights objf uses, so
        # the reported decomposition moves consistently with
        # objf_per_frame even when supervision weights vary in-batch
        w_tot = jnp.maximum(jnp.sum(weights), 1e-8)
        return EvalStepOutput(
            objf_per_frame=result.objf_per_frame,
            num_logprob=jnp.sum(weights * result.num_logprob) / w_tot,
            den_logprob=jnp.sum(weights * result.den_logprob) / w_tot,
            xent_objf=xent_objf,
            weight_frames=w_frames,
            ok=result.ok.all())

    return jax.jit(step) if jit else step
