"""Functional JAX network: init + forward for xconfig models.

Redesign of the reference forward engine
(ref: internal/nnet/forward.go).  Key departures, all deliberate:

  * Everything is batched [B, T, D] and lives in one jit: no per-op host
    round-trips (the reference bounced conv im2col and attention to the CPU,
    forward.go:418-524, 795-909 — its known hot spots).
  * Convolution is a patch-gather + single matmul per layer (the
    XLA-fusable equivalent of im2col where the gather is shifts, not
    scalar loops).  Feature-map layout is Kaldi's: column = height * nf + f.
  * BatchNorm follows Kaldi BatchNormComponent semantics: batch statistics
    during training (autodiff backprops through them — the reference used an
    inference-form approximation in its backward), accumulated running
    stats for test mode, target-rms scaling, no learnable gamma/beta.
  * Mixed precision: params are stored fp32; compute_dtype (bf16 for
    training) is applied at use; matmuls accumulate fp32 via preferred_element_type.

Parameters are a plain nested dict  params[layer_name][param_name] and
BN statistics live in a separate `state` dict, so the whole network is a
pytree ready for pjit/shard_map.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_fp16_tpu.models.xconfig import InputType, LayerType
from kaldi_fp16_tpu.models.layers import (
    AttentionSpec, BatchnormSpec, CombineFeatureMapsSpec, ConvReluBNSpec,
    IDCTSpec, Layer, LinearSpec, OutputSpec, PrefinalSpec, SpecAugmentSpec,
    TDNNFSpec,
)
from kaldi_fp16_tpu.models.model import Model

Params = Dict[str, Dict[str, jnp.ndarray]]
State = Dict[str, Dict[str, jnp.ndarray]]


# ---------------------------------------------------------------------------
# Fixed matrices
# ---------------------------------------------------------------------------

def make_idct_matrix(dim: int, cepstral_lifter: float) -> np.ndarray:
    """IDCT matrix used as x @ M, i.e. [in=cepstra, out=mel] orientation —
    the TRANSPOSE of Kaldi compute_idct_matrix's [out, in] affine
    (ref: forward.go:1190-1210; steps/libs/common.py).

    Two earlier bugs, both caught by the lifter round-trip test:
    the matrix was built in [out, in] orientation (computing a forward
    DCT under x @ M), and the lifter coefficient 1 + (Q/2) sin(pi i / Q)
    was MULTIPLIED instead of DIVIDED.  MFCC extraction multiplied
    cepstrum i by the coefficient; the inverse transform divides it back
    out on the CONTRACTION (cepstral) index before the inverse DCT."""
    mat = np.zeros((dim, dim), dtype=np.float64)
    for i in range(dim):          # cepstral (contraction) index
        lc = 1.0
        if cepstral_lifter > 0 and i > 0:
            lc = 1.0 + (cepstral_lifter / 2.0) * math.sin(
                math.pi * i / cepstral_lifter)
        norm = math.sqrt((1.0 if i == 0 else 2.0) / dim)
        for j in range(dim):      # output mel-bin index
            mat[i, j] = norm * math.cos(math.pi * i * (j + 0.5) / dim) / lc
    return mat.astype(np.float32)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _xavier(key, fan_in: int, fan_out: int) -> jnp.ndarray:
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return jax.random.normal(key, (fan_in, fan_out), dtype=jnp.float32) * scale


def init_params(model: Model, key: jax.Array) -> Tuple[Params, State]:
    params: Params = {}
    state: State = {}
    for layer in model.execution_order():
        key, sub = jax.random.split(key)
        p, s = _init_layer(layer, sub)
        if p:
            params[layer.name] = p
        if s:
            state[layer.name] = s
    return params, state


def _bn_state(dim: int) -> Dict[str, jnp.ndarray]:
    return {
        "count": jnp.zeros((), jnp.float32),
        "mean": jnp.zeros(dim, jnp.float32),
        "var": jnp.ones(dim, jnp.float32),
    }


def _init_layer(layer: Layer, key) -> Tuple[dict, dict]:
    s = layer.spec
    t = layer.type
    if t == LayerType.IDCT:
        return ({"idct": jnp.asarray(make_idct_matrix(s.dim, s.cepstral_lifter))},
                {})
    if t == LayerType.LINEAR:
        return ({"w": _xavier(key, s.input_dim, s.output_dim)}, {})
    if t == LayerType.BATCHNORM:
        return ({}, _bn_state(s.dim))
    if t == LayerType.CONV_RELU_BATCHNORM:
        k = len(s.offsets) * s.num_filters_in
        return ({"w": _xavier(key, k, s.num_filters_out),
                 "b": jnp.zeros(s.num_filters_out, jnp.float32)},
                _bn_state(s.output_dim))
    if t == LayerType.TDNNF:
        k1, k2 = jax.random.split(key)
        lin_in = s.input_dim * (2 if s.time_stride > 0 else 1)
        aff_in = s.bottleneck_dim * (2 if s.time_stride > 0 else 1)
        return ({"linear_w": _xavier(k1, lin_in, s.bottleneck_dim),
                 "affine_w": _xavier(k2, aff_in, s.output_dim),
                 "affine_b": jnp.zeros(s.output_dim, jnp.float32)},
                _bn_state(s.output_dim))
    if t == LayerType.ATTENTION_RELU_BATCHNORM:
        proj_dim = s.num_heads * s.input_dim_per_head
        return ({"w": _xavier(key, s.input_dim, proj_dim),
                 "b": jnp.zeros(proj_dim, jnp.float32)},
                _bn_state(s.output_dim))
    if t == LayerType.RELU_BATCHNORM:
        return ({"w": _xavier(key, s.input_dim, s.output_dim),
                 "b": jnp.zeros(s.output_dim, jnp.float32)},
                _bn_state(s.output_dim))
    if t == LayerType.PREFINAL:
        k1, k2 = jax.random.split(key)
        return ({"big_w": _xavier(k1, s.input_dim, s.big_dim),
                 "big_b": jnp.zeros(s.big_dim, jnp.float32),
                 "small_w": _xavier(k2, s.big_dim, s.small_dim)},
                {"bn1": _bn_state(s.big_dim), "bn2": _bn_state(s.small_dim)})
    if t == LayerType.OUTPUT:
        return ({"w": _xavier(key, s.input_dim, s.output_dim),
                 "b": jnp.zeros(s.output_dim, jnp.float32)}, {})
    return ({}, {})


def trainable_mask(model: Model, params: Params) -> Params:
    """Pytree of bools: False for fixed matrices (idct)."""
    mask = {}
    for lname, p in params.items():
        layer = model.layer_map.get(lname)
        fixed = layer is not None and layer.type == LayerType.IDCT
        mask[lname] = {k: not fixed for k in p}
    return mask


# ---------------------------------------------------------------------------
# Primitive blocks
# ---------------------------------------------------------------------------

def _matmul(x: jnp.ndarray, w: jnp.ndarray, dtype) -> jnp.ndarray:
    """bf16-in, fp32-accumulate matmul.

    For fp32 compute we request HIGHEST precision: a backend's default fp32
    matmul may round inputs to bf16 or TF32, which would silently degrade
    the fp32 verification path."""
    precision = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    return jnp.dot(x.astype(dtype), w.astype(dtype),
                   preferred_element_type=jnp.float32, precision=precision)


# Experiment knob: when True, batchnorm
# normalizes in the compute dtype (bf16) with fp32-ACCUMULATED reductions
# instead of materializing an fp32 upcast of the activation tensor — the
# saved residuals for the BN backward then stay bf16, halving that layer's
# HBM traffic.  Running statistics stay fp32 either way.  Toggle with
# set_bn_lowp_stats() BEFORE tracing (it is read at trace time).
_BN_LOWP_STATS = False


def set_bn_lowp_stats(enabled: bool) -> None:
    global _BN_LOWP_STATS
    _BN_LOWP_STATS = bool(enabled)


def _batchnorm(x: jnp.ndarray, bn_state: dict, target_rms: float,
               epsilon: float, train: bool) -> Tuple[jnp.ndarray, dict]:
    """Kaldi BatchNormComponent: stats over (batch, time), target-rms scale."""
    if _BN_LOWP_STATS and x.dtype != jnp.float32:
        return _batchnorm_lowp(x, bn_state, target_rms, epsilon, train)
    xf = x.astype(jnp.float32)
    if train:
        mean = xf.mean(axis=(0, 1))
        var = jnp.maximum(xf.var(axis=(0, 1)), 0.0)
        n = jnp.asarray(x.shape[0] * x.shape[1], jnp.float32)
        count = bn_state["count"] + n
        delta = mean - bn_state["mean"]
        new_mean = bn_state["mean"] + delta * (n / count)
        # parallel-variance (Chan) merge: the between-batch mean-shift term
        # keeps running var = E[x^2]-E[x]^2 over ALL frames, matching
        # Kaldi's sum/sum-sq accumulation (a plain weighted average of
        # per-batch variances underestimates it when batch means differ)
        old_n = bn_state["count"]
        new_var = (old_n * bn_state["var"] + n * var
                   + delta * delta * old_n * n / count) / count
        # first batch: old_n = 0 makes the formula exact (init var ignored)
        new_state = {"count": count, "mean": new_mean, "var": new_var}
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    scale = target_rms * jax.lax.rsqrt(var + epsilon)
    out = (xf - mean) * scale
    return out.astype(x.dtype), new_state


def _batchnorm_lowp(x: jnp.ndarray, bn_state: dict, target_rms: float,
                    epsilon: float, train: bool) -> Tuple[jnp.ndarray, dict]:
    """bf16-traffic batchnorm: reductions accumulate in fp32 (jnp dtype=
    argument) but no fp32 copy of x is ever materialized and the
    normalization itself runs in x.dtype.  Running-stat merge identical
    to the exact path (fp32 scalars)."""
    if train:
        mean = jnp.mean(x, axis=(0, 1), dtype=jnp.float32)
        # two-pass variance: the E[x^2]-mean^2 form cancels
        # catastrophically when |mean| >> std (fp32 resolution ~1e-3 at
        # mean~1e2); centering in the compute dtype first keeps the
        # reduction stable while still never materializing an fp32 copy
        centered = x - mean.astype(x.dtype)
        var = jnp.maximum(
            jnp.mean(jnp.square(centered), axis=(0, 1),
                     dtype=jnp.float32), 0.0)
        n = jnp.asarray(x.shape[0] * x.shape[1], jnp.float32)
        count = bn_state["count"] + n
        delta = mean - bn_state["mean"]
        new_mean = bn_state["mean"] + delta * (n / count)
        old_n = bn_state["count"]
        new_var = (old_n * bn_state["var"] + n * var
                   + delta * delta * old_n * n / count) / count
        new_state = {"count": count, "mean": new_mean, "var": new_var}
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    scale = (target_rms * jax.lax.rsqrt(var + epsilon))
    out = (x - mean.astype(x.dtype)) * scale.astype(x.dtype)
    return out, new_state


def _shift_time(x: jnp.ndarray, offset: int, mode: str) -> jnp.ndarray:
    """x[:, t] := x[:, t + offset]; out-of-range per mode ('zero'|'clamp')."""
    if offset == 0:
        return x
    T = x.shape[1]
    if mode == "zero":
        pad = jnp.zeros_like(x[:, :1])
        reps_hi = (1, offset) + (1,) * (x.ndim - 2)
        reps_lo = (1, -offset) + (1,) * (x.ndim - 2)
        if offset > 0:
            return jnp.concatenate([x[:, offset:], jnp.tile(pad, reps_hi)], axis=1)
        return jnp.concatenate([jnp.tile(pad, reps_lo), x[:, :T + offset]], axis=1)
    # clamp (replicate edge rows; ref splice helpers, forward.go:697-790)
    if offset > 0:
        return jnp.concatenate([x[:, offset:],
                                jnp.tile(x[:, -1:], (1, offset, 1))], axis=1)
    return jnp.concatenate([jnp.tile(x[:, :1], (1, -offset, 1)),
                            x[:, :T + offset]], axis=1)


def _splice(x: jnp.ndarray, offsets, mode: str) -> jnp.ndarray:
    """Concat time-shifted copies along the feature axis."""
    return jnp.concatenate([_shift_time(x, o, mode) for o in offsets], axis=-1)


# ---------------------------------------------------------------------------
# Natural-gradient site plumbing
# ---------------------------------------------------------------------------

class NGContext:
    """Carries natural-gradient taps into / matmul inputs out of a forward.

    A "site" is one affine/matmul application, keyed "<layer>/<param>".
    `taps[site]` (zeros, same shape as the site's pre-activation output) is
    ADDED at the site, so d loss/d tap = the per-sample output derivative G
    that Kaldi's NaturalGradientAffineComponent preconditions; `xs[site]`
    records the matmul input X.  See training/train_step.py.
    """

    def __init__(self, taps: Optional[dict] = None, collect: bool = False):
        self.taps = taps
        self.collect = collect
        self.xs: Dict[str, jnp.ndarray] = {}

    def site(self, name: str, x: jnp.ndarray, out: jnp.ndarray) -> jnp.ndarray:
        if self.collect:
            self.xs[name] = x
        if self.taps is not None and name in self.taps:
            out = out + self.taps[name]
        return out


def _site(ng: Optional[NGContext], name: str, x, out):
    return out if ng is None else ng.site(name, x, out)


# ---------------------------------------------------------------------------
# Layer forwards
# ---------------------------------------------------------------------------

def _even_spacing(offsets) -> Optional[int]:
    """Common difference of an ascending arithmetic offset sequence, or
    None if irregular (single offset -> 1)."""
    if len(offsets) == 1:
        return 1
    d = offsets[1] - offsets[0]
    if d <= 0 or any(offsets[i + 1] - offsets[i] != d
                     for i in range(len(offsets) - 1)):
        return None
    return d


def _fwd_conv_relu_bn(spec: ConvReluBNSpec, p: dict, bn: dict, x: jnp.ndarray,
                      train: bool, dtype, ng=None, lname="",
                      grid_cut=None) -> Tuple[jnp.ndarray, dict]:
    """Convolution over (time, height).  x: [B, T, H_in*nf_in] (filter
    fastest).

    Two lowerings, identical math:
      * DIRECT: one lax.conv_general_dilated with spatials (T, H) —
        dilation encodes evenly spaced offsets, stride the height
        subsample.  No patch materialization: the patch path writes+reads
        a [B, T, H_out, k*nf_in] concat (~0.9 GB bf16 per cnn layer at
        B=128) in BOTH passes, and fwd+bwd are bandwidth-bound, so
        skipping it buys real time.
      * PATCH: shifts + concat + one matmul.  Kept for irregular offset
        grids and for NG-SGD, whose Fisher factors tap the materialized
        patch as the matmul input (ref conv design: forward.go:418-524
        did this via CPU im2col round-trips).
    """
    B, T, _ = x.shape
    H_in, H_out = spec.height_in, spec.height_out
    nf_in, nf_out = spec.num_filters_in, spec.num_filters_out
    sub = spec.height_subsample

    # pad the height axis so h_src = h_out*sub + h_off always lands in-range
    h_offs = spec.height_offsets
    t_offs = spec.time_offsets
    pad_lo = max(0, -min(h_offs))
    pad_hi = max(0, (H_out - 1) * sub + max(h_offs) - (H_in - 1))

    dt = _even_spacing(t_offs)
    dh = _even_spacing(h_offs)
    direct = (ng is None and dt is not None and dh is not None
              and min(t_offs) <= 0 and min(h_offs) <= 0 <= max(h_offs))
    if grid_cut is not None:
        # cut conv (conv_cut_layers): full-rate input -> grid output via
        # a strided convolution window.  out[j] = the full-rate conv at
        # frame g_offset + j*g_stride, bit-equal to the unstrided conv at
        # those frames (same zero padding); only the frames in between
        # are never computed.  g_offset may be traced, so the padded
        # input is dynamic-sliced to start the first window at it.
        assert direct, "cut conv requires the direct lowering"
        g_stride, g_offset, n_grid = grid_cut
        xs = x.reshape(B, T, H_in, nf_in).astype(dtype)
        kernel = p["w"].reshape(len(t_offs), len(h_offs), nf_in,
                                nf_out).astype(dtype)
        ext = max(t_offs) - min(t_offs) + 1        # dilated kernel extent
        xpad = jnp.pad(xs, ((0, 0), (-min(t_offs), max(t_offs)),
                            (0, 0), (0, 0)))
        need = (n_grid - 1) * g_stride + ext
        xsl = jax.lax.dynamic_slice_in_dim(xpad, g_offset, need, axis=1)
        out = jax.lax.conv_general_dilated(
            xsl, kernel,
            window_strides=(g_stride, sub),
            padding=((0, 0), (pad_lo, pad_hi)),
            rhs_dilation=(dt, dh),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=(jax.lax.Precision.HIGHEST
                       if dtype == jnp.float32
                       else jax.lax.Precision.DEFAULT))
        out = (out[:, :, :H_out].astype(jnp.float32)
               + p["b"].astype(jnp.float32))
        out = jax.nn.relu(out)
        out = out.reshape(B, n_grid, H_out * nf_out).astype(dtype)
        return _batchnorm(out, bn, spec.target_rms, 1e-3, train)
    if direct:
        xs = x.reshape(B, T, H_in, nf_in).astype(dtype)
        kernel = p["w"].reshape(len(t_offs), len(h_offs), nf_in,
                                nf_out).astype(dtype)
        # no preferred_element_type: its vjp mixes f32 cotangents with
        # bf16 operands and conv requires uniform dtypes; bf16 convs
        # accumulate in f32 internally, so only the output rounding
        # differs (bf16, same class as the rest of the net; chip_smoke's
        # fwd phase checks it against the fp32 forward on the GPU).
        # HIGHEST for f32 compute: a backend default may round to bf16 or
        # TF32 and silently degrade the fp32 verification path (same
        # guard as _matmul).
        out = jax.lax.conv_general_dilated(
            xs, kernel,
            window_strides=(1, sub),
            padding=((-min(t_offs), max(t_offs)), (pad_lo, pad_hi)),
            rhs_dilation=(dt, dh),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=(jax.lax.Precision.HIGHEST
                       if dtype == jnp.float32
                       else jax.lax.Precision.DEFAULT))
        out = (out[:, :T, :H_out].astype(jnp.float32)
               + p["b"].astype(jnp.float32))
    else:
        patches = []
        for t_off in t_offs:
            xt = _shift_time(x, t_off, "zero").reshape(B, T, H_in, nf_in)
            if pad_lo or pad_hi:
                xt = jnp.pad(xt, ((0, 0), (0, 0), (pad_lo, pad_hi), (0, 0)))
            for h_off in h_offs:
                start = pad_lo + h_off
                sl = jax.lax.slice_in_dim(
                    xt, start, start + (H_out - 1) * sub + 1,
                    stride=sub, axis=2)
                patches.append(sl)                 # [B, T, H_out, nf_in]
        # offsets order matches spec.offsets (time-major, height fastest)
        patch = jnp.concatenate(patches, axis=-1)  # [B, T, H_out, k*nf_in]
        out = _matmul(patch, p["w"], dtype) + p["b"].astype(jnp.float32)
        out = _site(ng, f"{lname}/w", patch, out)
    out = jax.nn.relu(out)                         # [B, T, H_out, nf_out]
    out = out.reshape(B, T, H_out * nf_out)        # filter fastest: h*nf + f
    out = out.astype(dtype)
    return _batchnorm(out, bn, spec.target_rms, 1e-3, train)


def _fwd_tdnnf(spec: TDNNFSpec, p: dict, bn: dict, x: jnp.ndarray,
               train: bool, dtype, ng=None, lname="") -> Tuple[jnp.ndarray, dict]:
    """splice[-s,0] -> linear -> splice[0,+s] -> affine -> relu -> bn -> bypass
    (ref: forward.go:589-695; clamped edges)."""
    s = spec.time_stride
    lin_in = _splice(x, (-s, 0), "clamp") if s > 0 else x
    bottleneck = _matmul(lin_in, p["linear_w"], dtype)
    bottleneck = _site(ng, f"{lname}/linear_w", lin_in, bottleneck).astype(dtype)
    aff_in = _splice(bottleneck, (0, s), "clamp") if s > 0 else bottleneck
    out = _matmul(aff_in, p["affine_w"], dtype) + p["affine_b"].astype(jnp.float32)
    out = _site(ng, f"{lname}/affine_w", aff_in, out)
    out = jax.nn.relu(out).astype(dtype)
    out, new_bn = _batchnorm(out, bn, spec.target_rms, 1e-3, train)
    if spec.bypass_scale > 0 and spec.input_dim == spec.output_dim:
        out = out + jnp.asarray(spec.bypass_scale, out.dtype) * x
    return out, new_bn


def _fwd_attention(spec: AttentionSpec, p: dict, bn: dict, x: jnp.ndarray,
                   train: bool, dtype, ng=None, lname="") -> Tuple[jnp.ndarray, dict]:
    """Restricted per-head time attention, fully vectorized
    (ref: forward.go:795-909, which computed this on CPU per element)."""
    B, T, _ = x.shape
    H, kd, vd, cd = spec.num_heads, spec.key_dim, spec.value_dim, spec.context_dim
    stride = spec.time_stride

    proj = _matmul(x, p["w"], dtype) + p["b"].astype(jnp.float32)  # [B,T,H*iph]
    proj = _site(ng, f"{lname}/w", x, proj)
    proj = proj.reshape(B, T, H, spec.input_dim_per_head)
    keys = proj[..., :kd]                          # [B,T,H,kd]
    values = proj[..., kd:kd + vd]                 # [B,T,H,vd]
    q_key = proj[..., kd + vd: kd + vd + kd]       # [B,T,H,kd]
    q_ctx = proj[..., kd + vd + kd:]               # [B,T,H,cd]

    # offsets o=0..cd-1 map to key time t + (o - num_left)*stride
    outs_v = []
    outs_b = []
    for o in range(cd):
        delta = (o - spec.num_left_inputs) * stride
        k_o = _shift_time(keys, delta, "zero")     # zero pad outside
        v_o = _shift_time(values, delta, "zero")
        dot = (q_key.astype(jnp.float32) * k_o.astype(jnp.float32)).sum(-1)
        b_o = q_ctx[..., o].astype(jnp.float32) + spec.key_scale * dot  # [B,T,H]
        outs_b.append(b_o)
        outs_v.append(v_o)
    scores = jnp.stack(outs_b, axis=-1)            # [B,T,H,cd]
    attn = jax.nn.softmax(scores, axis=-1)
    vals = jnp.stack(outs_v, axis=-2)              # [B,T,H,cd,vd]
    ctx_out = jnp.einsum("bthc,bthcv->bthv", attn.astype(jnp.float32),
                         vals.astype(jnp.float32))
    out = jnp.concatenate([ctx_out, attn], axis=-1)  # [B,T,H,vd+cd]
    out = out.reshape(B, T, H * (vd + cd))
    out = jax.nn.relu(out).astype(dtype)
    return _batchnorm(out, bn, spec.target_rms, 1e-3, train)


def _fwd_spec_augment(spec: SpecAugmentSpec, x: jnp.ndarray, rng) -> jnp.ndarray:
    """Frequency band + time masks (ref spec: layers.go SpecAugmentSpec;
    go/gotorch/cnn_tdnn.go:613-669 for the mask shapes)."""
    B, T, D = x.shape
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    # frequency mask: one band of width uniform in [0, freq_max_proportion*D)
    max_w = int(spec.freq_max_proportion * D)
    if max_w > 0:  # freq-max-proportion=0 disables frequency masking
        width = jax.random.randint(k1, (B,), 0, max_w + 1)
        start = jax.random.randint(k2, (B,), 0, D)
        f_idx = jnp.arange(D)[None, :]
        f_mask = ~((f_idx >= start[:, None]) & (f_idx < (start + width)[:, None]))
        x = x * f_mask[:, None, :].astype(x.dtype)
    # time masks: zero roughly time_zeroed_proportion of frames
    if spec.time_zeroed_proportion > 0:
        n_masks = max(1, int(T * spec.time_zeroed_proportion
                             / max(1, spec.time_mask_max_frames // 2)))
        t_idx = jnp.arange(T)[None, None, :]
        starts = jax.random.randint(k3, (B, n_masks), 0, T)
        widths = jax.random.randint(k4, (B, n_masks), 0,
                                    spec.time_mask_max_frames + 1)
        hit = ((t_idx >= starts[:, :, None]) &
               (t_idx < (starts + widths)[:, :, None])).any(axis=1)
        x = x * (~hit)[:, :, None].astype(x.dtype)
    return x


def _fwd_combine_feature_maps(spec: CombineFeatureMapsSpec, x: jnp.ndarray
                              ) -> jnp.ndarray:
    """Interleave blocked feature maps into h*(nf1+nf2[+nf3]) + f layout
    (ref: ops.cu kernel_combine_feature_maps)."""
    B, T, D = x.shape
    h = spec.height
    nfs = [spec.num_filters1, spec.num_filters2]
    if spec.num_filters3:
        nfs.append(spec.num_filters3)
    blocks = []
    off = 0
    for nf in nfs:
        blocks.append(x[..., off:off + h * nf].reshape(B, T, h, nf))
        off += h * nf
    return jnp.concatenate(blocks, axis=-1).reshape(B, T, D)


# ---------------------------------------------------------------------------
# Time-grid analysis (the nnet3 computation-compiler equivalent)
# ---------------------------------------------------------------------------

def grid_layers(model: Model, stride: int,
                conv_cut: bool = False) -> frozenset:
    """Layers that can run on the stride-`stride` time grid.

    Real Kaldi's nnet3 compiler only computes each component at the
    frames its consumers actually request; with frame-subsampling-factor
    3 the whole post-CNN stack therefore runs at 1/3 the frame rate
    (ref: chain_loss.go:245-254 consumes every 3rd output row; the
    reference network, lacking a computation compiler, computed ALL
    layers at ALL frames — forward.go:148-202 — and so does our full-rate
    path).  A layer is grid-eligible iff

      * its own time offsets are all multiples of `stride` (pointwise
        layers trivially qualify; tdnnf time-stride 3 and attention
        time-stride 3 qualify at stride 3; conv offsets -1,0,1 do not),
      * every consumer of its activation is grid-eligible (model outputs
        only need grid frames, so output layers seed the set).

    Computed by one reverse pass over the execution order (consumers
    always come later).  SpecAugment is held full-rate so augmentation
    statistics (mask widths in real frames) never change meaning.

    conv_cut=True additionally admits "cut convolutions": a conv whose
    consumers are all grid layers emits grid frames DIRECTLY via a
    time-strided convolution window over its full-rate input (see
    conv_cut_layers) — bit-equal to full-rate conv + subsample (zero
    padding, no clamp semantics), at 1/stride the conv cost.  Cut convs
    keep full-rate inputs, so they never cascade upstream.
    """
    if stride <= 1:
        return frozenset()
    base = _grid_base(model, stride)
    if not conv_cut:
        return base
    return base | conv_cut_layers(model, stride)


def _grid_base(model: Model, stride: int) -> frozenset:
    order = model.execution_order()
    consumers = _consumers(model)

    def offsets_ok(layer: Layer) -> bool:
        t, s = layer.type, layer.spec
        if t == LayerType.TDNNF:
            return s.time_stride % stride == 0
        if t == LayerType.ATTENTION_RELU_BATCHNORM:
            return s.time_stride % stride == 0
        if t == LayerType.CONV_RELU_BATCHNORM:
            return all(o % stride == 0 for o in s.time_offsets)
        if t in (LayerType.INPUT, LayerType.SPEC_AUGMENT):
            return False
        return True     # pointwise: idct/linear/bn/combine/prefinal/output

    grid = set()
    for layer in reversed(order):
        if not offsets_ok(layer):
            continue
        cons = consumers[layer.name]
        is_out = layer.type == LayerType.OUTPUT
        if (is_out and not cons) or (cons and all(c in grid for c in cons)):
            grid.add(layer.name)
    return frozenset(grid)


def _consumers(model: Model) -> Dict[str, list]:
    order = model.execution_order()
    consumers: Dict[str, list] = {l.name: [] for l in order}
    prev = None
    for layer in order:
        if layer.type == LayerType.INPUT:
            prev = layer.name
            continue
        ref = layer.input.ref
        names = (list(layer.input.names) if ref.type != InputType.PREVIOUS
                 else [prev])
        for n in names:
            consumers[n].append(layer.name)
        prev = layer.name
    return consumers


def conv_cut_layers(model: Model, stride: int) -> frozenset:
    """Convs at the full->grid boundary that can emit grid frames via a
    time-strided convolution window (window_strides time = `stride`)
    over their FULL-RATE input.  Values are bit-equal to the full-rate
    conv at grid frames (zero padding either way — no clamp-semantics
    change; BN inside the layer then pools grid frames, as everywhere on
    the grid).  Requires the direct conv lowering (regular offset grids;
    _fwd_conv_relu_bn), so candidates with irregular offsets stay
    full-rate.  No cascade: a cut conv consumes full-rate input, so its
    producers never become grid-eligible through it."""
    if stride <= 1:
        return frozenset()
    base = _grid_base(model, stride)
    consumers = _consumers(model)
    cut = set()
    for layer in model.execution_order():
        if layer.type != LayerType.CONV_RELU_BATCHNORM:
            continue
        if layer.name in base:
            continue                     # already grid via divisible offsets
        s = layer.spec
        cons = consumers[layer.name]
        direct_ok = (_even_spacing(s.time_offsets) is not None
                     and _even_spacing(s.height_offsets) is not None
                     and min(s.time_offsets) <= 0
                     and min(s.height_offsets) <= 0 <= max(s.height_offsets))
        if direct_ok and cons and all(c in base for c in cons):
            cut.add(layer.name)
    return frozenset(cut)


def _grid_spec(layer: Layer, stride: int):
    """Layer spec with time offsets rescaled to grid steps."""
    import dataclasses
    t, s = layer.type, layer.spec
    if t == LayerType.TDNNF and s.time_stride:
        return dataclasses.replace(s, time_stride=s.time_stride // stride)
    if t == LayerType.ATTENTION_RELU_BATCHNORM and s.time_stride:
        return dataclasses.replace(s, time_stride=s.time_stride // stride)
    if t == LayerType.CONV_RELU_BATCHNORM and any(s.time_offsets):
        return dataclasses.replace(
            s, time_offsets=tuple(o // stride for o in s.time_offsets))
    return s


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

@dataclass
class Network:
    """Convenience wrapper binding a Model to its functional forward."""
    model: Model

    def init(self, key) -> Tuple[Params, State]:
        return init_params(self.model, key)

    def apply(self, params, state, features, ivectors=None, **kw):
        return forward(self.model, params, state, features, ivectors, **kw)


def forward(model: Model, params: Params, state: State,
            features: jnp.ndarray,                 # [B, T, feat_dim]
            ivectors: Optional[jnp.ndarray] = None,  # [B, ivec_dim]
            *, train: bool = False, rng=None,
            compute_dtype=jnp.bfloat16,
            ng_taps: Optional[dict] = None,
            collect_ng: bool = False,
            time_subsample: Optional[tuple] = None):
    """Run the network.  Returns ({output_name: [B, T, dim]}, new_state)
    — plus the dict of per-site matmul inputs when collect_ng=True (the
    natural-gradient statistics path, see NGContext).

    Output frames are NOT subsampled here; use `subsample_output` to pick
    the chain-supervision frames (ref: chain_loss.go:245-254).

    time_subsample=(stride, offset, n_grid) runs every grid-eligible
    layer (see grid_layers) on the frame grid {offset + k*stride,
    k < n_grid} instead of all T frames — the nnet3-compiler frame-rate
    optimization (~3x less compute/traffic for the post-CNN stack at
    frame-subsampling-factor 3).  `offset` may be a traced value;
    `stride` and `n_grid` must be static.  Grid-layer outputs come back
    with n_grid frames (time axis = grid steps); grid-layer BatchNorm
    statistics accumulate over grid frames only, exactly as real Kaldi's
    compiled computation does.  Edge clamping happens at grid edges
    (full Kaldi computes context rows outside the supervised range when
    the eg provides them; at chunk boundaries both designs replicate
    edges).
    """
    ng = (NGContext(ng_taps, collect_ng)
          if (ng_taps is not None or collect_ng) else None)
    B, T, _ = features.shape
    dtype = compute_dtype
    acts: Dict[str, jnp.ndarray] = {}
    new_state: State = dict(state)
    outputs: Dict[str, jnp.ndarray] = {}

    grid: frozenset = frozenset()
    cut: frozenset = frozenset()
    g_stride = 1
    if time_subsample is not None:
        g_stride, g_offset, n_grid = time_subsample
        grid = grid_layers(model, g_stride)
        # cut convs need the direct lowering, which the NG tap path
        # disables (Fisher factors tap the materialized patch)
        if ng is None:
            cut = conv_cut_layers(model, g_stride)
            grid = grid | cut

    def to_grid(a: jnp.ndarray) -> jnp.ndarray:
        """Full-rate [B, T, ...] -> grid [B, n_grid, ...]."""
        sl = jax.lax.dynamic_slice_in_dim(
            a, g_offset, (n_grid - 1) * g_stride + 1, axis=1)
        return sl[:, ::g_stride]

    def get_input(layer: Layer, prev_name: Optional[str]) -> jnp.ndarray:
        ref = layer.input.ref
        # cut convs consume FULL-RATE input (the stride lives in their
        # convolution window), so no subsample at read time
        on_grid = layer.name in grid and layer.name not in cut
        if ref.type == InputType.PREVIOUS:
            assert prev_name is not None, f"{layer.name}: no previous layer"
            names = [prev_name]
        else:
            names = list(layer.input.names)
        parts = []
        for n in names:
            a = acts[n]
            if on_grid and n not in grid:
                a = to_grid(a)          # the full->grid cut
            parts.append(a)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, -1)

    prev_name: Optional[str] = None
    for layer in model.execution_order():
        t = layer.type
        # cut convs keep their original offsets (the stride lives in the
        # convolution window), so no offset rescale for them
        s = (_grid_spec(layer, g_stride)
             if layer.name in grid and layer.name not in cut
             else layer.spec)
        if t == LayerType.INPUT:
            if layer.name == "ivector":
                assert ivectors is not None, "model requires ivectors"
                iv = ivectors.astype(dtype)
                acts[layer.name] = jnp.broadcast_to(
                    iv[:, None, :], (B, T, iv.shape[-1]))
            else:
                acts[layer.name] = features.astype(dtype)
            prev_name = layer.name
            continue

        x = get_input(layer, prev_name)

        if t == LayerType.IDCT:
            out = _matmul(x, params[layer.name]["idct"], dtype)
        elif t == LayerType.LINEAR:
            out = _matmul(x, params[layer.name]["w"], dtype)
            out = _site(ng, f"{layer.name}/w", x, out)
        elif t == LayerType.BATCHNORM:
            out, ns = _batchnorm(x, state[layer.name], s.target_rms,
                                 s.epsilon, train)
            new_state[layer.name] = ns
        elif t == LayerType.SPEC_AUGMENT:
            if train and rng is not None:
                rng, sub = jax.random.split(rng)
                out = _fwd_spec_augment(s, x, sub)
            else:
                out = x
        elif t == LayerType.COMBINE_FEATURE_MAPS:
            out = _fwd_combine_feature_maps(s, x)
        elif t == LayerType.CONV_RELU_BATCHNORM:
            gc = ((g_stride, g_offset, n_grid)
                  if layer.name in cut else None)
            out, ns = _fwd_conv_relu_bn(s, params[layer.name],
                                        state[layer.name], x, train, dtype,
                                        ng=ng, lname=layer.name,
                                        grid_cut=gc)
            new_state[layer.name] = ns
        elif t == LayerType.TDNNF:
            out, ns = _fwd_tdnnf(s, params[layer.name], state[layer.name],
                                 x, train, dtype, ng=ng, lname=layer.name)
            new_state[layer.name] = ns
        elif t == LayerType.ATTENTION_RELU_BATCHNORM:
            out, ns = _fwd_attention(s, params[layer.name], state[layer.name],
                                     x, train, dtype, ng=ng, lname=layer.name)
            new_state[layer.name] = ns
        elif t == LayerType.RELU_BATCHNORM:
            p = params[layer.name]
            out = _matmul(x, p["w"], dtype) + p["b"].astype(jnp.float32)
            out = _site(ng, f"{layer.name}/w", x, out)
            out = jax.nn.relu(out).astype(dtype)
            out, ns = _batchnorm(out, state[layer.name], s.target_rms,
                                 1e-3, train)
            new_state[layer.name] = ns
        elif t == LayerType.PREFINAL:
            p = params[layer.name]
            st = state[layer.name]
            big = _matmul(x, p["big_w"], dtype) + p["big_b"].astype(jnp.float32)
            big = _site(ng, f"{layer.name}/big_w", x, big)
            big = jax.nn.relu(big).astype(dtype)
            big, ns1 = _batchnorm(big, st["bn1"], s.target_rms, 1e-3, train)
            small = _matmul(big, p["small_w"], dtype)
            small = _site(ng, f"{layer.name}/small_w", big, small).astype(dtype)
            out, ns2 = _batchnorm(small, st["bn2"], s.target_rms, 1e-3, train)
            new_state[layer.name] = {"bn1": ns1, "bn2": ns2}
        elif t == LayerType.OUTPUT:
            p = params[layer.name]
            out = _matmul(x, p["w"], dtype) + p["b"].astype(jnp.float32)
            out = _site(ng, f"{layer.name}/w", x, out)
            if s.include_log_softmax:
                out = jax.nn.log_softmax(out, axis=-1)
            outputs[layer.name] = out  # outputs stay fp32
        else:
            out = x

        acts[layer.name] = out.astype(dtype) if t != LayerType.OUTPUT else out
        prev_name = layer.name

    if collect_ng:
        return outputs, new_state, ng.xs
    return outputs, new_state


def ng_sites(model: Model):
    """Registry of natural-gradient sites for a model: one per matmul
    application, with the param names and dims needed to precondition the
    accumulated gradient (see training/train_step.py)."""
    sites = []
    for layer in model.layers:
        t, sp, n = layer.type, layer.spec, layer.name
        if t == LayerType.LINEAR:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b=None,
                              in_dim=sp.input_dim, out_dim=sp.output_dim,
                              tap=("BT", sp.output_dim)))
        elif t == LayerType.RELU_BATCHNORM:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=sp.output_dim,
                              tap=("BT", sp.output_dim)))
        elif t == LayerType.CONV_RELU_BATCHNORM:
            k = len(sp.offsets) * sp.num_filters_in
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=k, out_dim=sp.num_filters_out,
                              tap=("BTH", sp.height_out, sp.num_filters_out)))
        elif t == LayerType.TDNNF:
            m = 2 if sp.time_stride > 0 else 1
            sites.append(dict(name=f"{n}/linear_w", layer=n, w="linear_w",
                              b=None, in_dim=sp.input_dim * m,
                              out_dim=sp.bottleneck_dim,
                              tap=("BT", sp.bottleneck_dim)))
            sites.append(dict(name=f"{n}/affine_w", layer=n, w="affine_w",
                              b="affine_b", in_dim=sp.bottleneck_dim * m,
                              out_dim=sp.output_dim,
                              tap=("BT", sp.output_dim)))
        elif t == LayerType.ATTENTION_RELU_BATCHNORM:
            proj = sp.num_heads * sp.input_dim_per_head
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=proj,
                              tap=("BT", proj)))
        elif t == LayerType.PREFINAL:
            sites.append(dict(name=f"{n}/big_w", layer=n, w="big_w",
                              b="big_b", in_dim=sp.input_dim,
                              out_dim=sp.big_dim, tap=("BT", sp.big_dim)))
            sites.append(dict(name=f"{n}/small_w", layer=n, w="small_w",
                              b=None, in_dim=sp.big_dim, out_dim=sp.small_dim,
                              tap=("BT", sp.small_dim)))
        elif t == LayerType.OUTPUT:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=sp.output_dim,
                              tap=("BT", sp.output_dim)))
    return sites


def make_ng_taps(sites, B: int, T: int,
                 grid: frozenset = frozenset(),
                 n_grid: int = 0) -> Dict[str, jnp.ndarray]:
    """Zero tap arrays for one batch geometry.  Sites on the subsampled
    time grid (see grid_layers / forward's time_subsample) tap n_grid
    frames instead of T."""
    taps = {}
    for s in sites:
        Ts = n_grid if s["layer"] in grid else T
        if s["tap"][0] == "BT":
            taps[s["name"]] = jnp.zeros((B, Ts, s["tap"][1]), jnp.float32)
        else:  # BTH: conv, [B, T, H_out, nf_out]
            taps[s["name"]] = jnp.zeros((B, Ts, s["tap"][1], s["tap"][2]),
                                        jnp.float32)
    return taps


def subsample_output(x: jnp.ndarray, stride: int, offset: int,
                     num_frames: int) -> jnp.ndarray:
    """Pick chain-supervision frames: rows offset, offset+stride, ...
    (ref: gpu.SubsampleRows, ops.cu kernel_subsample_rows; chain_loss.go)."""
    return jax.lax.slice_in_dim(x, offset, offset + (num_frames - 1) * stride + 1,
                                stride=stride, axis=1)
