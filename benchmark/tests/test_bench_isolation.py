"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or the JAX package crimac_unet_tpu (compared whole: the port's name
begins with the JAX package's), and the reference nothing of the port."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "crimac_unet_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports):
    p = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=ROOT, imports=imports)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("imports", [
    "import benchmark.run as r; r._cache_env()\n"
    "import benchmark.yardstick.predict_cell, benchmark.yardstick.train_cell\n"
    "import crimac_unet_tpu_torch.pipeline.predict\n"
    "import crimac_unet_tpu_torch.pipeline.train\n"
    "import crimac_unet_tpu_torch.data.zarr_reader\n"
    "for m in r.load_bench()['per_layer']: r.load_reader(m['name'])\n"
    "r.load_architecture({})",
    "import benchmark.control",
], ids=["run", "control"])
def test_harness_loads_no_jax(imports):
    assert not _top_level(imports) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("import benchmark.reference.unet, "
                      "benchmark.reference.precision, "
                      "benchmark.reference.predict, "
                      "benchmark.reference.train, "
                      "benchmark.reference.surveys")
    assert not mods & (FORBIDDEN | {"crimac_unet_tpu_torch"})


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark",
                                            "architectures"))
    if f.endswith(".py")))
def test_architecture_adapter_loads_nothing_of_the_program(name):
    """An adapter imports the program only inside ``program``: loading it
    loads no module of the port."""
    mods = _top_level("import benchmark.run as r\n"
                      f"r.load_architecture({{'architecture': {name!r}}})")
    assert not mods & (FORBIDDEN | {"crimac_unet_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "crimac_unet_tpu_torch_x", sys)
    assert "crimac_unet_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "crimac_unet_tpu.models", sys)
    assert "crimac_unet_tpu" in run.forbidden_modules()
