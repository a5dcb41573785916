"""chip_smoke.py refuses to report a result anywhere but on a GPU, and its
CPU rehearsal runs every phase at tiny sizes."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd=REPO, script=SCRIPT, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _assert_no_result(p):
    assert '"ok"' not in p.stdout


def test_cpu_run_fails_without_result():
    p = _run([])
    assert p.returncode != 0
    _assert_no_result(p)
    assert "not a GPU" in p.stderr


@pytest.mark.parametrize("args", [["--no-gpu-check"],
                                  ["--no-gpu-check", "--four"]])
def test_gpu_check_switch_refused_without_rehearse(args):
    p = _run(args)
    assert p.returncode == 2
    _assert_no_result(p)
    assert "only accepted with --rehearse" in p.stderr


def test_rehearse_keeps_the_gpu_check():
    p = _run(["--rehearse"])
    assert p.returncode != 0
    _assert_no_result(p)


def test_script_alone_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    p = _run(["--rehearse", "--no-gpu-check"], cwd=str(tmp_path),
             script=str(tmp_path / "chip_smoke.py"))
    assert p.returncode != 0
    _assert_no_result(p)


def test_rehearsal_runs_every_phase():
    p = _run(["--rehearse", "--no-gpu-check"])
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    _assert_no_result(p)
    for tag in ("[device]", "[kernel] flagship_L0", "[kernel] sgbm_1280",
                "[flagship] kernel", "[flagship] reference", "[live] frame 1",
                "[matcher] SGBM", "[matcher] BM", "[rehearsal]"):
        assert tag in p.stdout, tag
