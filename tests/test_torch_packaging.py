"""Packaging of the port: the wheel carries the port's kernel sources and
new modules, names its console scripts, and runs its selfcheck from an
isolated install with the repository off the path."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {
    "crimac-torch-train": "crimac_unet_tpu_torch.pipeline.train:main",
    "crimac-torch-evaluate": "crimac_unet_tpu_torch.pipeline.evaluate:main",
    "crimac-torch-save-predict":
        "crimac_unet_tpu_torch.pipeline.save_predict:main",
    "crimac-torch-school-eval":
        "crimac_unet_tpu_torch.pipeline.school_eval:main",
    "crimac-torch-export": "crimac_unet_tpu_torch.pipeline.export:main",
    "crimac-torch-selfcheck": "crimac_unet_tpu_torch.selfcheck:main",
}


def _run(args, **kw):
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=600, **kw)
    assert proc.returncode == 0, \
        f"{args} failed:\nSTDOUT:{proc.stdout[-3000:]}\n" \
        f"STDERR:{proc.stderr[-3000:]}"
    return proc


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """One wheel, built from a copy of the sources: setuptools builds in
    the source tree's build/ directory, which tests/test_packaging.py
    uses at the same time under xdist."""
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("crimac_unet_tpu", "crimac_unet_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "__pycache__", "*.so"))
    out = tmp_path_factory.mktemp("wheel")
    _run([sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
          "--no-deps", "--no-index", "-w", str(out), str(src)])
    wheels = list(out.glob("crimac_unet_tpu-*.whl"))
    assert len(wheels) == 1, wheels
    return wheels[0]


def test_wheel_carries_the_port(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    csrc = sorted(p.name for p in (REPO / "crimac_unet_tpu_torch" /
                                   "csrc").iterdir()
                  if p.suffix in (".cu", ".cuh"))
    assert any(n.endswith(".cu") for n in csrc) and \
        any(n.endswith(".cuh") for n in csrc)
    for name in csrc:
        assert f"crimac_unet_tpu_torch/csrc/{name}" in names, name
    for probe in ("crimac_unet_tpu_torch/native/chunkio.cc",
                  "crimac_unet_tpu_torch/pipeline/export.py",
                  "crimac_unet_tpu_torch/pipeline/inference.py",
                  "crimac_unet_tpu_torch/selfcheck.py",
                  "crimac_unet_tpu_torch/utils/flops.py",
                  "crimac_unet_tpu_torch/utils/timing.py",
                  "crimac_unet_tpu_torch/utils/profiling.py",
                  "crimac_unet_tpu_torch/examples/"
                  "example_aot_deployment.py"):
        assert probe in names, probe
    assert not [n for n in names if n.endswith(".so")], names


def test_wheel_names_the_port_scripts(wheel):
    zf = zipfile.ZipFile(wheel)
    entry = next(n for n in zf.namelist() if n.endswith("entry_points.txt"))
    eps = dict(line.split(" = ", 1) for line in
               zf.read(entry).decode().splitlines() if " = " in line)
    for script, target in SCRIPTS.items():
        assert eps.get(script) == target, (script, eps)
    meta = next(n for n in zf.namelist() if n.endswith("METADATA"))
    text = zf.read(meta).decode()
    assert "Provides-Extra: torch" in text
    for dep in ("torch", "numpy", "scipy"):
        assert f'Requires-Dist: {dep}; extra == "torch"' in text, dep


def test_installed_wheel_runs_port_selfcheck(wheel, tmp_path):
    """Installed to an isolated --target dir, with the repository off
    PYTHONPATH: the port's selfcheck passes on the CPU from there."""
    site = tmp_path / "site"
    _run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
          "--target", str(site), str(wheel)])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(site)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and Path(p).resolve() != REPO])
    proc = subprocess.run(
        [sys.executable, "-c",
         "import crimac_unet_tpu_torch, sys;"
         "assert crimac_unet_tpu_torch.__file__.startswith(sys.argv[1]),"
         " crimac_unet_tpu_torch.__file__;"
         "from crimac_unet_tpu_torch.selfcheck import main;"
         "sys.exit(main(['--skip-device']))",
         str(site)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, \
        f"port selfcheck from installed wheel failed:\n" \
        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    assert "SELFCHECK PASSED" in proc.stdout
