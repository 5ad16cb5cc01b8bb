"""Semi-orthogonal constraint for factorized (TDNN-F) layers.

Kaldi keeps the bottleneck linear of every tdnnf-layer (and the prefinal
small linear) semi-orthogonal: M M^T ~= scale^2 I, with a floating scale
when orthonormal-constraint < 0 and a fixed scale when > 0 (Povey et al.,
"Semi-Orthogonal Low-Rank Matrix Factorization for Deep Neural Networks",
Interspeech 2018; Kaldi nnet-utils.cc ConstrainOrthonormal).  Without it,
TDNN-F training from random init is markedly less stable.

The reference PARSES the xconfig option but never applies it (the
`OrthonormalConstraint` field is written at layers.go:45,221 and read
nowhere else), so this is a capability this build adds on top of
parity.  Kaldi applies the update on a random ~1/4 of steps; here the
trainer applies it deterministically every `orthonormal_interval` steps
(XLA-friendly: one lax.cond on the step counter, no host randomness).

Update rule (ConstrainOrthonormal):

    P = M M^T                     (M arranged rows <= cols)
    scale^2 = constraint^2        (fixed)  or  tr(PP)/tr(P)  (floating)
    ratio = tr(PP) * rows / tr(P)^2   >= 1, == 1 iff orthogonal
    speed = 0.125, halved when ratio > 1.02, quartered when > 1.1
    M <- M - 4 * speed / scale^2 * (P - scale^2 I) M

which is gradient descent on f(M) = sum((M M^T - scale^2 I)^2).
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from kaldi_fp16_tpu.models.model import Model
from kaldi_fp16_tpu.models.xconfig import LayerType


def constrain_orthonormal(w: jnp.ndarray, constraint: float,
                          update_speed: float = 0.125) -> jnp.ndarray:
    """One constraint step on a weight stored [in, out] (network
    convention).  Kaldi's M is [out, in]; the update runs on whichever
    orientation gives rows <= cols, matching ConstrainOrthonormal's
    requirement, and returns the same [in, out] layout."""
    transpose = w.shape[1] <= w.shape[0]
    m = w.T if transpose else w
    m32 = m.astype(jnp.float32)
    p = m32 @ m32.T                                   # [r, r]
    r = p.shape[0]
    trace_p = jnp.trace(p)
    trace_pp = jnp.sum(p * p)
    scale2 = (jnp.float32(constraint) ** 2 if constraint > 0
              else trace_pp / trace_p)
    ratio = trace_pp * r / (trace_p * trace_p)
    speed = jnp.where(ratio > 1.1, update_speed * 0.25,
                      jnp.where(ratio > 1.02, update_speed * 0.5,
                                update_speed))
    p2 = p - scale2 * jnp.eye(r, dtype=jnp.float32)
    m_new = (m32 - (4.0 * speed / scale2) * (p2 @ m32)).astype(w.dtype)
    return m_new.T if transpose else m_new


def orthonormal_targets(model: Model) -> List[Tuple[str, str, float]]:
    """(layer_name, param_name, constraint) for every param whose layer
    spec requests a semi-orthogonal constraint (!= 0)."""
    out = []
    for layer in model.layers:
        c = getattr(layer.spec, "orthonormal_constraint", 0.0)
        if not c:
            continue
        if layer.type == LayerType.TDNNF:
            out.append((layer.name, "linear_w", float(c)))
        elif layer.type == LayerType.PREFINAL:
            out.append((layer.name, "small_w", float(c)))
        elif layer.type == LayerType.LINEAR:
            out.append((layer.name, "w", float(c)))
    return out
