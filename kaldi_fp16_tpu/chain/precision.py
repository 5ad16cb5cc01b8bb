"""The matmul precision of the exact-mode chain math.

The structured den, the blocked den and the numerator contract fp32 values
(transition probabilities, alphas, betas, log-probabilities) against fp32
matrices and one-hots.  Their exact mode must stay in the fp32 accuracy
class on every backend: XLA's `HIGH` precision level means three bf16
passes on some backends but one TF32 pass on NVIDIA GPUs, the accuracy
class of the den's `fast` mode.  So the choice is made here, once, and
every exact-mode dot in `chain/` uses it.

HIGHEST asks XLA for full fp32 products.  The other candidate,
`DotAlgorithmPreset.BF16_BF16_F32_X3` (three bf16 tensor-core passes),
ran the flagship structured den faster on an H100 but keeps only ~16
mantissa bits of each operand: the numerator's one-hot gathers of
log-probabilities near 75 then drift by ~1e-3, off the fp64 oracle by
3.3e-3 in posteriors where HIGHEST is at 1.9e-5.
"""

import jax

EXACT_PRECISION = jax.lax.Precision.HIGHEST
