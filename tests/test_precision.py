"""The exact-mode chain precision: one fp32-class choice
(`chain/precision.py`) that reaches every dot of the structured den, the
blocked den and the numerator, and that keeps them on the fp64 oracle."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu.chain.graph import (
    DenominatorGraph, build_numerator_batch, make_phone_lm_den_fst,
    make_simple_den_fst,
)
from kaldi_fp16_tpu.chain.numerator import _num_forward_backward
from kaldi_fp16_tpu.chain.precision import EXACT_PRECISION
from kaldi_fp16_tpu.chain.reference import (
    denominator_forward_backward_plain, denominator_forward_backward_ref,
)
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.io.sparse import fst_to_csr

FP32_CLASS = (jax.lax.Precision.HIGHEST,
              jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
              jax.lax.DotAlgorithmPreset.F32_F32_F32)


def _marker():
    """How EXACT_PRECISION reads on a lowered stablehlo.dot_general."""
    if isinstance(EXACT_PRECISION, jax.lax.Precision):
        name = EXACT_PRECISION.name
        return f"precision = [{name}, {name}]"
    return "algorithm = <"


def _lowered_dots(kind):
    x = jnp.zeros((2, 5, 24), jnp.float32)
    if kind in ("structured", "blocked"):
        fst = (make_phone_lm_den_fst(24, 12, 2, 4, seed=3)
               if kind == "structured"
               else make_simple_den_fst(num_pdfs=24, num_states=8, seed=1))
        den = DenominatorComputation(DenominatorGraph.from_fst(fst, 24),
                                     leaky=1e-5, layout=kind)
        assert den.layout_used == kind
        text = den._forward_backward.lower(den, x,
                                           compute_grad=True).as_text()
    else:
        g = build_numerator_batch([fst_to_csr(_linear_fst(
            np.random.default_rng(0), 5, 24))] * 2)
        text = _num_forward_backward.lower(
            g.arc_src, g.arc_dst, g.arc_pdf, g.arc_logw, g.arc_mask,
            g.start, g.final_logw, x, num_states=g.num_states).as_text()
    return re.findall(r"stablehlo\.dot_general.*", text)


def _linear_fst(rng, frames, pdfs):
    states = [FstState() for _ in range(frames + 1)]
    for t in range(frames):
        for w in (0.0, 1.0):
            states[t].arcs.append(
                FstArc(int(rng.integers(1, pdfs + 1)), w, t + 1))
    states[-1].final = 0.0
    return Fst(start=0, states=states)


def test_exact_precision_is_fp32_class():
    assert EXACT_PRECISION in FP32_CLASS


@pytest.mark.parametrize("kind", ["structured", "blocked", "numerator"])
def test_exact_precision_reaches_lowered_dots(kind):
    dots = _lowered_dots(kind)
    assert dots, f"no dot_general lowered for {kind}"
    marker = _marker()
    for d in dots:
        assert marker in d, d


# (num_pdfs, num_phones, states_per_phone, branching, seed)
PHONE_LM = [(24, 12, 2, 4, 3), (40, 20, 3, 5, 7), (64, 30, 2, 6, 11)]


@pytest.mark.parametrize("leaky", [0.0, 1e-5])
@pytest.mark.parametrize("shape", PHONE_LM, ids=lambda s: f"P{s[0]}-ph{s[1]}")
def test_structured_den_matches_fp64_oracle(shape, leaky):
    P, phones, spp, branching, seed = shape
    graph = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(P, phones, spp, branching, seed=seed), P)
    den = DenominatorComputation(graph, leaky=leaky)
    assert den.layout_used == "structured"
    out = (np.random.default_rng(seed).normal(size=(3, 11, P)) * 0.5
           ).astype(np.float32)
    lp, post = den.forward_backward(jnp.asarray(out))
    for b in range(3):
        rl, rp = denominator_forward_backward_ref(graph, out[b], leaky)
        assert abs(float(lp[b]) - rl) <= 2e-6 * max(1.0, abs(rl))
        np.testing.assert_allclose(np.asarray(post[b]), rp, atol=1e-6)


@pytest.mark.parametrize("kind", ["phone-lm", "random"])
def test_plain_den_reference_matches_fp64_oracle(kind):
    fst = (make_phone_lm_den_fst(24, 12, 2, 4, seed=3) if kind == "phone-lm"
           else make_simple_den_fst(num_pdfs=24, num_states=8, seed=1))
    graph = DenominatorGraph.from_fst(fst, 24)
    out = (np.random.default_rng(5).normal(size=(2, 9, 24)) * 0.5
           ).astype(np.float32)
    lp, post = denominator_forward_backward_plain(graph, out, 1e-5)
    for b in range(2):
        rl, rp = denominator_forward_backward_ref(graph, out[b], 1e-5)
        assert abs(float(lp[b]) - rl) <= 2e-6 * max(1.0, abs(rl))
        np.testing.assert_allclose(np.asarray(post[b]), rp, atol=1e-6)


@pytest.mark.gpu
def test_exact_precision_is_fp32_class_on_gpu(gpu_device):
    """On the card a bare HIGH dot runs in TF32; EXACT_PRECISION must not."""
    rng = np.random.default_rng(0)
    a = rng.random((1024, 1024)).astype(np.float32)
    b = rng.random((1024, 128)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = jnp.matmul(jax.device_put(a, gpu_device), b,
                     precision=EXACT_PRECISION,
                     preferred_element_type=jnp.float32)
    rel = np.abs(np.asarray(got, np.float64) - want) / np.abs(want)
    assert rel.max() < 1e-5
