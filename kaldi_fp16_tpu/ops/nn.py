"""NN building blocks: 1-D conv/pooling/norm/SE/dropout over [B, T, C].

Functional JAX equivalents of the reference's CNN kernel set
(ref: cpp/cuda/cnn_kernels.cu:19-663 — conv1d fwd/bwd, maxpool1d with saved
argmax, avgpool1d, x-vector stats pooling, layernorm, depthwise + pointwise
conv, SE block; go/gotorch/cnn_tdnn.go Conv1D/StatsPooling/Dropout).
Backward passes come from autodiff; convolutions are lax.conv_general_dilated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def conv1d(x: jnp.ndarray, w: jnp.ndarray, b: Optional[jnp.ndarray] = None,
           stride: int = 1, padding: str = "SAME",
           dilation: int = 1) -> jnp.ndarray:
    """x [B, T, Cin], w [K, Cin, Cout] -> [B, T', Cout]."""
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,), padding=padding,
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32)
    if b is not None:
        out = out + b
    return out.astype(x.dtype)


def max_pool1d(x: jnp.ndarray, window: int, stride: Optional[int] = None,
               padding: str = "VALID") -> jnp.ndarray:
    """x [B, T, C] -> [B, T', C]."""
    stride = stride or window
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, window, 1), window_strides=(1, stride, 1),
        padding=padding)


def avg_pool1d(x: jnp.ndarray, window: int, stride: Optional[int] = None,
               padding: str = "VALID") -> jnp.ndarray:
    stride = stride or window
    summed = jax.lax.reduce_window(
        x, 0.0, jax.lax.add,
        window_dimensions=(1, window, 1), window_strides=(1, stride, 1),
        padding=padding)
    counts = jax.lax.reduce_window(
        jnp.ones_like(x), 0.0, jax.lax.add,
        window_dimensions=(1, window, 1), window_strides=(1, stride, 1),
        padding=padding)
    return summed / counts


def stats_pooling(x: jnp.ndarray, eps: float = 1e-10,
                  mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """x-vector statistics pooling: concat(mean_t, std_t): [B, T, C] -> [B, 2C]
    (ref: cnn_kernels.cu stats_pooling_fp16; gotorch StatsPooling)."""
    if mask is not None:
        m = mask[..., None].astype(x.dtype)
        n = jnp.maximum(m.sum(axis=1), 1.0)
        mean = (x * m).sum(axis=1) / n
        var = ((x - mean[:, None, :]) ** 2 * m).sum(axis=1) / n
    else:
        mean = x.mean(axis=1)
        var = x.var(axis=1)
    std = jnp.sqrt(var + eps)
    return jnp.concatenate([mean, std], axis=-1)


def layer_norm(x: jnp.ndarray, gamma: Optional[jnp.ndarray] = None,
               beta: Optional[jnp.ndarray] = None,
               eps: float = 1e-5) -> jnp.ndarray:
    """Per-frame layer norm over the channel axis."""
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    out = (x - mean) * jax.lax.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def depthwise_separable_conv1d(x: jnp.ndarray, dw: jnp.ndarray,
                               pw: jnp.ndarray,
                               b: Optional[jnp.ndarray] = None,
                               stride: int = 1,
                               padding: str = "SAME") -> jnp.ndarray:
    """Depthwise [K, 1, C] then pointwise [1, C, Cout]
    (ref: cnn_kernels.cu depthwise/pointwise conv1d)."""
    C = x.shape[-1]
    depth = jax.lax.conv_general_dilated(
        x, dw, window_strides=(stride,), padding=padding,
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=C,
        preferred_element_type=jnp.float32).astype(x.dtype)
    return conv1d(depth, pw, b, stride=1, padding="SAME")


def squeeze_excite(x: jnp.ndarray, w1: jnp.ndarray, b1: jnp.ndarray,
                   w2: jnp.ndarray, b2: jnp.ndarray) -> jnp.ndarray:
    """SE block over time: squeeze = mean_t, excite = sigmoid MLP gate
    (ref: cnn_kernels.cu SE block)."""
    squeeze = x.mean(axis=1)                          # [B, C]
    hidden = jax.nn.relu(squeeze @ w1 + b1)
    gate = jax.nn.sigmoid(hidden @ w2 + b2)           # [B, C]
    return x * gate[:, None, :]


def dropout(x: jnp.ndarray, rate: float, rng, train: bool = True) -> jnp.ndarray:
    """Inverted dropout (ref: gotorch layers.go Dropout)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
