"""CLI wiring tests: every tool parses --help; --cpu-capable drivers run
a tiny smoke.  Catches argparse/import regressions (a round-2 review
found a documented flag that argparse never defined).

Full tool runs happen on the GPU (see README "Running on the GPU"); only
--cpu or jax-free smokes run here, so that no subprocess tries to take
an accelerator while the test suite holds the CPU.
"""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "tools", "*.py"))
    if not os.path.basename(p).startswith("_"))


def run_tool(name, *args, timeout=240):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", name), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)


@pytest.mark.parametrize("tool", TOOLS)
def test_help_parses(tool):
    if tool == "mpworker.py":
        pytest.skip("worker entry; driven by test_multiprocess")
    if "argparse" not in open(os.path.join(REPO, "tools", tool)).read():
        pytest.skip("no CLI flags (fixed-recipe test tool)")
    r = run_tool(tool, "--help")
    assert r.returncode == 0, r.stderr[-800:]
    assert "usage" in (r.stdout + r.stderr).lower()


def test_xvectortrain_smoke():
    r = run_tool("xvectortrain.py", "--cpu", "--steps", "30",
                 "--speakers", "4", "--batch", "16", "--frames", "20")
    assert r.returncode == 0, r.stderr[-800:]
    assert '"ok": true' in r.stdout


def test_documented_flags_exist():
    """Every flag mentioned in a tool's module docstring Usage block
    must be a real argparse option (regression for the abtest
    --steps-per-epoch doc bug)."""
    import re
    for tool in TOOLS:
        path = os.path.join(REPO, "tools", tool)
        src = open(path).read()
        m = re.search(r'"""(.*?)"""', src, re.S)
        if not m:
            continue
        # only the Usage: block — prose may cite flags of OTHER programs
        # (e.g. loadtest quotes Kaldi's own `nnet3-copy --binary=false`)
        u = re.search(r"Usage:(.*?)(?:\n\n|$)", m.group(1), re.S)
        if not u:
            continue
        # kebab-case only: snake_case --flags are XLA_FLAGS env examples
        usage = [f for f in re.findall(r"--[a-z][a-z0-9_-]*", u.group(1))
                 if "_" not in f]
        defined = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
        if not defined:
            continue
        for flag in usage:
            assert flag in defined or flag == "--help", \
                f"{tool} documents {flag} but never defines it"


def test_decode_demo_smoke():
    """decode.py demo mode on the CPU backend: synthetic graph +
    posteriors -> transcript + WER line (the end-to-end wiring of the
    net-new decode stack, BASELINE config 5)."""
    r = run_tool("decode.py", "--cpu")
    assert r.returncode == 0, r.stderr[-800:]
    assert "WER" in r.stdout and "demo-utt" in r.stdout


def test_synthwer_smoke():
    """Closed-loop accuracy proof: train the chain model on synthetic
    speech, decode held-out utterances through a word-loop graph, and
    WER must fall to 0 (tools/synthwer.py; BASELINE config 5's
    decode-after-train end state on the data available here)."""
    r = run_tool("synthwer.py", "--cpu", "--steps", "45",
                 "--train-utts", "96", "--test-utts", "12",
                 "--eval-every", "15", "--lm-rescore", "--streaming")
    assert r.returncode == 0, r.stderr[-800:]
    assert '"ok": true' in r.stdout
    assert '"lm_rescore"' in r.stdout  # ARPA write -> read -> rescore ran
    assert '"streaming"' in r.stdout   # windowed online decode ran
