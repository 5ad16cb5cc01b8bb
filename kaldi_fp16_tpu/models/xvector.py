"""X-vector speaker-embedding models (functional JAX).

Covers the reference's GoTorch x-vector capability (ref:
go/gotorch/cnn_tdnn.go:383-554 XVectorConfig/BuildCNNTDNN — a pure-Go CPU
stack there; here it reuses the same JAX blocks as the acoustic model):
frame-level TDNN layers with spliced temporal contexts -> statistics
pooling (mean+stddev over time, ref cnn_kernels.cu stats_pooling_fp16)
-> segment-level affines.  The first segment affine's pre-activation is
the x-vector embedding (Snyder et al. 2018 convention).

Everything is a pytree of params + pure functions: jit/pjit/grad ready.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.ops.nn import stats_pooling


@dataclass(frozen=True)
class XVectorConfig:
    """Standard Kaldi x-vector recipe shape (5 TDNN + 2 segment layers)."""
    feat_dim: int = 30
    tdnn_dims: Tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_contexts: Tuple[Tuple[int, ...], ...] = (
        (-2, -1, 0, 1, 2), (-2, 0, 2), (-3, 0, 3), (0,), (0,))
    embed_dim: int = 512
    segment_dims: Tuple[int, ...] = (512, 512)
    num_speakers: int = 0          # 0 = no classifier head


def _xavier(key, fan_in, fan_out):
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return jax.random.normal(key, (fan_in, fan_out), jnp.float32) * scale


def init_xvector(cfg: XVectorConfig, key) -> Dict:
    params: Dict = {}
    dim = cfg.feat_dim
    for i, (out, ctx) in enumerate(zip(cfg.tdnn_dims, cfg.tdnn_contexts)):
        key, sub = jax.random.split(key)
        params[f"tdnn{i}"] = {
            "w": _xavier(sub, dim * len(ctx), out),
            "b": jnp.zeros(out, jnp.float32),
        }
        dim = out
    dim = 2 * dim  # stats pooling: mean + stddev
    for i, out in enumerate(cfg.segment_dims):
        key, sub = jax.random.split(key)
        params[f"segment{i}"] = {
            "w": _xavier(sub, dim, out),
            "b": jnp.zeros(out, jnp.float32),
        }
        dim = out
    if cfg.num_speakers:
        key, sub = jax.random.split(key)
        params["output"] = {"w": _xavier(sub, dim, cfg.num_speakers),
                            "b": jnp.zeros(cfg.num_speakers, jnp.float32)}
    return params


def _splice(x: jnp.ndarray, offsets: Sequence[int]) -> jnp.ndarray:
    """Concat time-shifted copies (edge-clamped) along features
    (the GoTorch TDNN layer's arbitrary-context splice with clamping,
    ref: go/gotorch/layers.go:409-535)."""
    T = x.shape[1]
    cols = []
    for o in offsets:
        idx = jnp.clip(jnp.arange(T) + o, 0, T - 1)
        cols.append(x[:, idx, :])
    return jnp.concatenate(cols, axis=-1)


def xvector_forward(cfg: XVectorConfig, params: Dict, feats: jnp.ndarray,
                    compute_dtype=jnp.float32
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """feats [B, T, feat_dim] -> (embedding [B, embed], logits [B, spk]|None).

    The embedding is segment0's PRE-activation (Kaldi extract.sh default).
    """
    x = feats.astype(compute_dtype)
    for i, ctx in enumerate(cfg.tdnn_contexts):
        p = params[f"tdnn{i}"]
        x = _splice(x, ctx)
        x = jnp.dot(x, p["w"].astype(compute_dtype),
                    preferred_element_type=jnp.float32) + p["b"]
        x = jax.nn.relu(x).astype(compute_dtype)
    pooled = stats_pooling(x.astype(jnp.float32))          # [B, 2*dim]

    h = pooled
    embedding = None
    for i in range(len(cfg.segment_dims)):
        p = params[f"segment{i}"]
        pre = jnp.dot(h, p["w"], preferred_element_type=jnp.float32) + p["b"]
        if i == 0:
            embedding = pre
        h = jax.nn.relu(pre)
    logits = None
    if "output" in params:
        p = params["output"]
        logits = jnp.dot(h, p["w"], preferred_element_type=jnp.float32) + p["b"]
    return embedding, logits


def xvector_loss(cfg: XVectorConfig, params: Dict, feats: jnp.ndarray,
                 labels: jnp.ndarray) -> jnp.ndarray:
    """Cross-entropy speaker-classification training loss."""
    from kaldi_fp16_tpu.ops.losses import cross_entropy
    _, logits = xvector_forward(cfg, params, feats)
    return cross_entropy(logits, labels)
