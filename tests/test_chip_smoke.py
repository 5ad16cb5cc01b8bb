"""chip_smoke.py: it refuses to run without a GPU, and each of its phases
passes at tiny widths on the CPU (the phases run at full width on the
card)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY_XCONFIG = """\
input name=ivector dim=100
input name=input dim=40
linear-component name=linear1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=48
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=48 bottleneck-dim=24 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=48 bottleneck-dim=24 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal-chain input=tdnnf2 small-dim=24 big-dim=48
output-layer name=output dim=24 include-log-softmax=false
prefinal-layer name=prefinal-xent input=tdnnf2 small-dim=24 big-dim=48
output-layer name=output-xent dim=24
"""


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny.xconfig"
    path.write_text(TINY_XCONFIG)
    return chip_smoke.Widths(
        xconfig=str(path), pdfs=24, den_phones=12, den_branching=4,
        batch=4, frames_in=30, frames_out=9, num_arcs=27, oracle_batch=2,
        oracle_frames=4, epoch_batches=2, warmup_steps=1, train_steps=15,
        repeat_steps=2,
        decode_states=64, decode_pdfs=16, decode_arcs=4, decode_batch=3,
        decode_frames=20, decode_ref_utts=3)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _refused(r):
    last = (r.stdout.strip().splitlines() or [""])[-1]
    return r.returncode != 0 and '"ok": true' not in last


def test_refuses_cpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert _refused(r), (r.returncode, r.stdout, r.stderr)
    assert "no GPU" in r.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert _refused(r), (r.returncode, r.stdout, r.stderr)


@pytest.mark.parametrize("phase", ["den", "num", "fwd", "train", "decode"])
def test_phase_at_tiny_width(phase, tiny, tmp_path):
    if phase == "train":
        res = chip_smoke.phase_train(tiny, str(tmp_path))
        assert res["steps"] == tiny.warmup_steps + tiny.train_steps
        assert res["repeat_bit_equal"]
        assert res["process_loader_batches"] == 2
    else:
        res = getattr(chip_smoke, f"phase_{phase}")(tiny)
    assert res


def test_phase_fails_loudly(tiny, monkeypatch):
    """A phase off its reference raises; nothing is swallowed."""
    monkeypatch.setattr(chip_smoke, "NUM_POST_RTOL", -1.0)
    with pytest.raises(chip_smoke.PhaseFailure, match="num posteriors"):
        chip_smoke.phase_num(tiny)


def test_data_parallel_matches_one_device(tiny, tmp_path):
    """The --four-cards path on four virtual CPU devices."""
    res = chip_smoke.phase_data_parallel(tiny, str(tmp_path), n_dev=4)
    assert res["mesh"]["data"] == 4
    assert (res["bfloat16"]["first_step_rel_diff"]
            <= chip_smoke.DP_FIRST_STEP_RTOL)
    assert (res["float32"]["first_step_rel_diff"]
            <= chip_smoke.DP_F32_FIRST_STEP_RTOL)
    assert res["float32"]["max_loss_rel_diff"] <= 1e-3
    assert (res["float32"]["first_grad_norm_rel_diff"]
            <= chip_smoke.DP_GRAD_NORM_RTOL)
    assert (res["float32"]["update_leaf_rel_max"]
            <= chip_smoke.DP_UPDATE_MARGIN)
    assert res["all_reduce_ops_in_step"] > 0


def test_data_parallel_catches_a_wrong_update(tiny, tmp_path, monkeypatch):
    """A data-parallel step whose update is half the one-card update
    (as a gradient averaged twice over the shards would give) fails the
    phase: the check has teeth beyond the noise floor it allows."""
    trainer = chip_smoke._trainer

    def halved(w, den, model, mesh=None, lr=1e-2, **kw):
        return trainer(w, den, model, mesh=mesh,
                       lr=lr / 2 if mesh is not None else lr, **kw)
    monkeypatch.setattr(chip_smoke, "_trainer", halved)
    with pytest.raises(chip_smoke.PhaseFailure, match="first update"):
        chip_smoke.phase_data_parallel(tiny, str(tmp_path), n_dev=4)
