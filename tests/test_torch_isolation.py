"""The PyTorch port stands alone: it imports no JAX stack, no pandas and
nothing of the JAX package, runs on CUDA unless asked for the CPU, and
builds its kernels only when one is launched."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "crimac_unet_tpu_torch"
# pandas, msgpack, sklearn and psutil: the card's machine has none; bench
# (the JAX package's benchmark) imports JAX, and so do the JAX repo's
# scripts that a port script could import by their bare names
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes",
             "crimac_unet_tpu", "pandas", "msgpack", "sklearn", "psutil",
             "bench", "r3_tpu_session", "fast_recipe", "meta_recipe",
             "school_ap_trained", "eval_quant_bench", "school_serving_bench",
             "school_postproc_sweep", "pooled_meta_bench", "static_grid_tpu"}


def _imported_roots(path: Path):
    """The top-level modules a file imports, and the modules it imports
    from the repo's ``scripts`` directory (``scripts.x`` yields ``x``)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                yield from parts[:2] if parts[0] == "scripts" else parts[:1]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            parts = node.module.split(".")
            yield from parts[:2] if parts[0] == "scripts" else parts[:1]
            if node.module == "scripts":
                yield from (a.name for a in node.names)


def _port_files():
    """The package, ``chip_smoke.py`` and the port's scripts
    (``scripts/torch_*.py``)."""
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("torch_*.py")))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run(code, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_runner_on_cpu_leaves_jax_out_of_sys_modules():
    code = """
import sys
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.pipeline import (dockerscript, evaluate,
                                            save_predict, school_eval, train)
from crimac_unet_tpu_torch.data import meta_channels
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.data import zarr_reader, preprocess, fixtures
cfg = {"patch_size": [64, 64], "patch_overlap": 8, "depth": 2,
       "start_filts": 4, "frequencies": [18, 38, 120, 200],
       "compute_dtype": "float32"}
r = GriddedRunner(build_unet(cfg), build_unet(cfg).state_dict(), cfg,
                  device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
print("LOADED", bad)
""" % (FORBIDDEN,)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_runner_without_device_raises_without_cuda(monkeypatch):
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"patch_size": [64, 64], "patch_overlap": 8, "depth": 2,
           "start_filts": 4, "compute_dtype": "float32",
           "frequencies": [18, 38, 120, 200]}
    sd = build_unet(cfg).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GriddedRunner(build_unet(cfg), sd, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GriddedRunner(build_unet(cfg), sd, dict(cfg, device=None))
    # an explicit CPU request (argument or config key) is honoured
    assert GriddedRunner(build_unet(cfg), sd, dict(cfg, device="cpu")
                         ).device.type == "cpu"


def test_cli_without_device_raises_without_cuda(tmp_path, monkeypatch):
    from crimac_unet_tpu_torch.pipeline.save_predict import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from crimac_unet_tpu_torch.models.unet import UNet
    torch.save(UNet(depth=2, start_filts=4).state_dict(), tmp_path / "m.pt")
    (tmp_path / "c.yaml").write_text(
        "depth: 2\nstart_filts: 4\ncompute_dtype: float32\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--yaml_path", str(tmp_path / "c.yaml"), "--checkpoint_path",
              str(tmp_path / "m.pt"), "--save_predictions_path",
              str(tmp_path / "out")])


def test_kernel_modules_import_without_nvcc():
    """Importing the kernel modules builds nothing and needs no nvcc: the
    build happens at the first launch on a CUDA tensor."""
    code = """
import shutil
assert shutil.which("nvcc") is None
from crimac_unet_tpu_torch.ops import cuda_lib, closing, gather_db, pool
from crimac_unet_tpu_torch.models import unet
assert cuda_lib._lib is None
print("OK", cuda_lib.launches)
"""
    proc = _run(code, {"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK {'gather_db': 0" in proc.stdout


def test_docker_entry_without_device_raises_without_cuda(tmp_path,
                                                        monkeypatch):
    """The docker entry with no config file runs on CUDA: without a card
    it raises and writes nothing."""
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    from crimac_unet_tpu_torch.models.unet import UNet
    from crimac_unet_tpu_torch.pipeline import dockerscript
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch.save(UNet(depth=2, start_filts=4).state_dict(), tmp_path / "m.pt")
    sv = make_zarr_survey(tmp_path, n_echograms=1, H=40, W=60, seed=1)
    monkeypatch.setenv("MODELWEIGHTS", str(tmp_path / "m.pt"))
    monkeypatch.setenv("SURVEY_PATH", sv)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    monkeypatch.delenv("CONFIG_PATH", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dockerscript.main()
    assert not (tmp_path / "predictions.zarr").exists()


def test_eval_cli_without_device_raises_without_cuda(tmp_path, monkeypatch):
    from crimac_unet_tpu_torch.models.unet import UNet
    from crimac_unet_tpu_torch.pipeline.evaluate import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch.save(UNet(depth=2, start_filts=4).state_dict(), tmp_path / "m.pt")
    (tmp_path / "c.yaml").write_text(
        "depth: 2\nstart_filts: 4\ncompute_dtype: float32\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--yaml_path", str(tmp_path / "c.yaml"), "--checkpoint_path",
              str(tmp_path / "m.pt"), "--save_path_metrics",
              str(tmp_path / "metrics"), "--save_path_plot",
              str(tmp_path / "plots")])


def test_school_eval_cli_without_device_raises_without_cuda(tmp_path,
                                                            monkeypatch):
    """The live school-eval CLI runs on CUDA: without --device and without
    a card it raises; from written predictions it needs no device."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.models.unet import UNet
    from crimac_unet_tpu_torch.pipeline.school_eval import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = make_survey_dir(tmp_path / "memm", year=2017, n_echograms=1, H=40,
                        W=60, seed=1)[0]
    torch.save(UNet(depth=2, start_filts=4).state_dict(), tmp_path / "m.pt")
    (tmp_path / "setpyenv.json").write_text(
        '{"path_to_echograms": "%s"}' % (tmp_path / "memm"))
    monkeypatch.setenv("CRIMAC_SETPYENV", str(tmp_path / "setpyenv.json"))
    base = ("depth: 2\nstart_filts: 4\ncompute_dtype: float32\n"
            "patch_size: [32, 32]\npatch_overlap: 4\n"
            "partition_predict: selected surveys\n"
            "evaluation_surveys: [2017]\n")
    (tmp_path / "live.yaml").write_text(base)
    args = ["--checkpoint_path", str(tmp_path / "m.pt"),
            "--save_path_metrics", str(tmp_path / "metrics"),
            "--save_path_plot", str(tmp_path / "plots")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--yaml_path", str(tmp_path / "live.yaml")] + args)
    (tmp_path / "preds").mkdir()
    import numpy as np
    np.save(tmp_path / "preds" / (os.path.basename(d) + "_pred.npy"),
            np.zeros((2, 40, 60), np.float16))
    (tmp_path / "stored.yaml").write_text(
        base + f"school_from_predictions: {tmp_path / 'preds'}\n")
    main(["--yaml_path", str(tmp_path / "stored.yaml")] + args)
    assert (tmp_path / "metrics" / "stored" / tmp_path.name /
            "2017_school_eval.csv").is_file()


OPTIONAL = ("h5py", "matplotlib", "pyarrow", "pandas")


def test_every_module_imports_without_optional_packages(tmp_path):
    """The card's machine has no h5py, matplotlib, pyarrow or pandas:
    every port module imports with them blocked, the onboarding chain
    (a .snap included) runs, and each function that needs one of them
    raises an ImportError naming it."""
    code = """
import importlib, pkgutil, sys
for name in %r:
    sys.modules[name] = None
import numpy as np
import crimac_unet_tpu_torch as pkg
mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + "."))
for m in mods:
    importlib.import_module(m)
print("IMPORTED", len(mods))

from crimac_unet_tpu_torch.data import ek60, fixtures, korona
from crimac_unet_tpu_torch.data.mat_to_memmap import convert_survey_tree
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.pipeline import segpipe
from crimac_unet_tpu_torch.utils import plotting
tmp = sys.argv[1]
ech = Echogram(fixtures.make_survey_dir(tmp + "/src", n_echograms=1, H=40,
                                        W=60, seed=1)[0])
raw = fixtures.write_raw_trio(ech, tmp + "/cruise")
assert ek60.convert_survey_raw(tmp + "/cruise", tmp + "/mat") == {
    ech.name: "ok"}
assert convert_survey_tree(tmp + "/mat") == [ech.name]
onb = Echogram(tmp + "/mat/memmap/" + ech.name)
assert (np.asarray(onb.label_memmap(heave=False)) != 0).any()
zr = DataReaderZarr(fixtures.make_zarr_survey(tmp + "/z", n_echograms=1,
                                              H=40, W=60, seed=1))
calls = {
    "h5py": [lambda: ek60.save_transducer_depths(raw, tmp + "/d.h5"),
             lambda: korona.get_transducer_depths(ech, root_depths=tmp)],
    "matplotlib": [lambda: ech.visualize(), lambda: zr.visualize(),
                   lambda: plotting.visualize_predictions_vs_labels(
                       zr, tmp + "/none.zarr"),
                   lambda: plotting.visualize_school_detections(ech, []),
                   lambda: segpipe.save_pr_plot({}, tmp + "/pr.png")],
    "pyarrow": [lambda: zr.create_label_mask_from_work(tmp + "/w.parquet")],
}
for name, fns in calls.items():
    for fn in fns:
        try:
            fn()
        except ImportError as exc:
            assert name in str(exc), (name, exc)
        else:
            raise AssertionError(f"{fn} ran without {name}")
print("RAISED", sum(len(v) for v in calls.values()))
""" % (OPTIONAL,)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = sum(1 for p in PORT.rglob("*.py") if p.name != "__main__.py") - 1
    assert f"IMPORTED {n}" in proc.stdout, proc.stdout
    assert "RAISED 8" in proc.stdout, proc.stdout
