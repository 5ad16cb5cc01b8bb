"""Dynamic loss scaling (ref: cpp/include/tensor_fp16.h LossScaler —
init 65536, growth 2.0 every 2000 good steps, backoff 0.5 on overflow;
kernels.cu check_overflow_kernel).

bf16 shares fp32's exponent range, so scaling is rarely needed for bf16
compute; it is provided for fp16-compute parity and as a guard for
pathological batches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class LossScaleState(NamedTuple):
    scale: jnp.ndarray        # current multiplier
    good_steps: jnp.ndarray   # consecutive overflow-free steps
    growth_interval: jnp.ndarray
    growth_factor: jnp.ndarray
    backoff_factor: jnp.ndarray
    min_scale: jnp.ndarray
    max_scale: jnp.ndarray


def init_loss_scale(initial: float = 65536.0, growth_interval: int = 2000,
                    growth_factor: float = 2.0, backoff_factor: float = 0.5,
                    min_scale: float = 1.0, max_scale: float = 2.0 ** 24
                    ) -> LossScaleState:
    return LossScaleState(
        scale=jnp.asarray(initial, jnp.float32),
        good_steps=jnp.zeros((), jnp.int32),
        growth_interval=jnp.asarray(growth_interval, jnp.int32),
        growth_factor=jnp.asarray(growth_factor, jnp.float32),
        backoff_factor=jnp.asarray(backoff_factor, jnp.float32),
        min_scale=jnp.asarray(min_scale, jnp.float32),
        max_scale=jnp.asarray(max_scale, jnp.float32),
    )


def grads_finite(grads) -> jnp.ndarray:
    leaves = jax.tree_util.tree_leaves(grads)
    return jnp.all(jnp.stack([jnp.all(jnp.isfinite(g)) for g in leaves]))


def unscale_grads(grads, state: LossScaleState):
    inv = 1.0 / state.scale
    return jax.tree_util.tree_map(lambda g: g * inv, grads)


def update_loss_scale(state: LossScaleState, finite: jnp.ndarray
                      ) -> Tuple[LossScaleState, jnp.ndarray]:
    """Returns (new_state, skip_update) — skip when grads overflowed."""
    good = jnp.where(finite, state.good_steps + 1, 0)
    grow = good >= state.growth_interval
    new_scale = jnp.where(
        finite,
        jnp.where(grow,
                  jnp.minimum(state.scale * state.growth_factor, state.max_scale),
                  state.scale),
        jnp.maximum(state.scale * state.backoff_factor, state.min_scale))
    new_good = jnp.where(grow, 0, good)
    return state._replace(scale=new_scale, good_steps=new_good), ~finite
