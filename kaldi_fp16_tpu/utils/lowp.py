"""Low-precision conversion + loss analysis.

The reference ships a software IEEE-754 binary16 codec with conversion-loss
statistics used to validate that the 2600h dataset survives fp16 ingestion
with zero overflow/underflow (ref: internal/fp16/fp16.go:13-184; BASELINE
row "FP16 conversion over 6.5M examples: 0 overflow / 0 underflow").  The
training dtype here is bfloat16, but both codecs are provided so the
same audit can be run for either target format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F16_MAX = np.float32(65504.0)
F16_MIN_NORMAL = np.float32(6.103515625e-05)   # 2^-14
BF16_MAX = np.float32(3.3895314e38)
BF16_MIN_NORMAL = np.float32(1.1754944e-38)    # 2^-126


def f32_to_f16(x: np.ndarray) -> np.ndarray:
    """IEEE binary16 with round-to-nearest-even (numpy semantics match the
    reference's hand-rolled codec, incl. subnormals and Inf/NaN)."""
    return np.asarray(x, dtype=np.float32).astype(np.float16)


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float16).astype(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """bfloat16 via round-to-nearest-even bit truncation; returns float32
    values on the bf16 grid."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    rounding = 0x7FFF + ((bits >> 16) & 1)
    out = ((bits + rounding) & 0xFFFF0000).astype(np.uint32)
    # NaN payloads must stay NaN
    nan_mask = np.isnan(x)
    res = out.view(np.float32).copy()
    res[nan_mask] = np.nan
    return res.reshape(np.shape(x))


@dataclass
class ConversionStats:
    """(ref: fp16.Stats, internal/fp16/fp16.go:130-184)."""
    count: int
    max_abs_err: float
    avg_abs_err: float
    max_rel_err: float
    overflow: int       # |x| > format max (becomes inf)
    underflow: int      # 0 < |x| < smallest normal (subnormal or zero)

    def ok(self) -> bool:
        return self.overflow == 0 and self.underflow == 0


def analyze_conversion(x: np.ndarray, fmt: str = "bfloat16") -> ConversionStats:
    x = np.asarray(x, dtype=np.float32).ravel()
    if fmt in ("fp16", "float16"):
        conv = f16_to_f32(f32_to_f16(x))
        fmax, fmin = F16_MAX, F16_MIN_NORMAL
    elif fmt in ("bf16", "bfloat16"):
        conv = f32_to_bf16(x)
        fmax, fmin = BF16_MAX, BF16_MIN_NORMAL
    else:
        raise ValueError(f"unknown format {fmt}")
    finite = np.isfinite(x)
    ax = np.abs(x[finite])
    err = np.abs(conv[finite] - x[finite])
    nz = ax > 0
    rel = np.zeros_like(err)
    rel[nz] = err[nz] / ax[nz]
    return ConversionStats(
        count=int(x.size),
        max_abs_err=float(err.max()) if err.size else 0.0,
        avg_abs_err=float(err.mean()) if err.size else 0.0,
        max_rel_err=float(rel.max()) if rel.size else 0.0,
        overflow=int((ax > fmax).sum()),
        underflow=int(((ax > 0) & (ax < fmin)).sum()),
    )
