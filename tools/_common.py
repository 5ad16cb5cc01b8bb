"""Shared bootstrap for the CLI tools."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kaldi_fp16_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,F401


def force_cpu():
    """Run a tool on the CPU backend (the tools' --cpu flag)."""
    import jax
    jax.config.update("jax_platforms", "cpu")


def read_metrics(path):
    """Rows of a metrics JSONL file; tolerates a torn tail line (a
    killed training run tears its last write)."""
    import json
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows


# NOTE: enable_compile_cache() is called explicitly from each tool's
# main() — NOT at import time — so that merely importing a tool module
# (tests, numpy-only helpers) has no filesystem or jax-config side
# effects.
