"""chip_smoke.py: its phases at a tiny size on the CPU, its refusal to run
anywhere but a GPU, and (``gpu`` marker) the script itself on a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_main_path_phase_and_checks_at_128(tmp_path):
    """The main path and every reference check pass on a 128 x 128 scene
    (the CPU stands in for the card here)."""
    res = chip_smoke.main_path_phase(128, 0, str(tmp_path), n_segments=30,
                                     n_estimators=10, n_points=80)
    assert res["cold_s"] > 0 and res["warm_s"] > 0
    assert "objects.glcm" in res["stages"]
    assert res["scene"].dtype.name == "uint16" and res["scene"].max() <= 2047
    checks = chip_smoke.reference_checks(res, 0, 10, slic_size=128,
                                         slic_segments=30)
    failed = [(name, detail) for name, ok, detail in checks if not ok]
    assert not failed, failed


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_gpu(script, tmp_path):
    """With the CPU platform forced, neither script prints a result."""
    proc = subprocess.run(
        [sys.executable, str(REPO / script)], cwd=tmp_path, text=True,
        capture_output=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"value"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.gpu
def test_chip_smoke_on_card(tmp_path):
    """The script end to end on a small scene, on the GPU of this machine."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--size", "1024"],
        cwd=tmp_path, text=True, capture_output=True, timeout=1200, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
