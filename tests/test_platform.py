"""What the program assumes of the machine it runs on: the persistent
compile cache's one directory, the published device peaks, and no kernel
tied to one accelerator's compiler."""

import os
import re

import jax
import pytest

from kaldi_fp16_tpu.utils import compile_cache
from kaldi_fp16_tpu.utils.profiling import DEVICE_PEAKS, device_peaks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config(monkeypatch, tmp_path):
    """Restore JAX's cache directory afterwards; point the in-repo
    default at a temporary directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(compile_cache, "REPO_CACHE_DIR",
                        str(tmp_path / "repo_cache"))
    yield tmp_path
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(cache_config, monkeypatch):
    env_dir = str(cache_config / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert compile_cache.enable_compile_cache() == env_dir
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert not os.path.exists(compile_cache.REPO_CACHE_DIR)


def test_compile_cache_falls_back_to_repo_dir(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_compile_cache_path_is_fixed(monkeypatch):
    """No temporary name, process id or time: the default is one
    directory inside the checkout, the same on every call."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert (compile_cache.enable_compile_cache()
                == compile_cache.enable_compile_cache()
                == os.path.join(REPO, ".jax_cache"))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peaks_h100_row():
    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_tflops"] == 989.0 and p["hbm_gbs"] == 3350.0
    assert p is DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]


def test_peaks_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("NVIDIA A100-SXM4-80GB")


def test_no_experimental_kernel_imports():
    """The package, tools/, bench.py and chip_smoke.py import nothing from
    jax.experimental (where JAX's kernel languages live): every device op
    is XLA's until a hand-written kernel earns its place on the card."""
    pat = re.compile(r"^\s*(from|import)\s+jax\.experimental", re.M)
    files = [os.path.join(REPO, "bench.py"),
             os.path.join(REPO, "chip_smoke.py")]
    for sub in ("kaldi_fp16_tpu", "tools"):
        for root, _, names in os.walk(os.path.join(REPO, sub)):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert len(files) > 50 and not hits, hits
