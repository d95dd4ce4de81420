"""A configuration names its architecture, and the harness reaches the
model only through that architecture's adapter: the U-Net adapter gives
the FLOP and byte counts and the checks the harness gave before it had
adapters, a renamed copy of it enters by new files alone, and a name or
mode an adapter cannot serve stops the run with a message.

The literals were read on the CPU from the harness as it was before the
adapters (commit 792f271), with the same calls and seeds: the counts from
``useful_flops_per_pass`` / ``kernel_bytes_per_pass`` /
``counts.train_step_flops`` on the cells' tiny surveys (made from seed
777), the checks from ``tiny_run`` with a window of one pass or step.
"""

import copy
import json
import os
import re

import pytest

from benchmark import run
from benchmark.yardstick import counts, predict_cell

from .conftest import ROOT, TINY_CONFIG, tiny_workload

BENCH = run.load_bench()
UNET = os.path.join(ROOT, "benchmark", "architectures", "unet.py")
SURVEY_SEED = 777

COUNTS = {
    ("predict_zarr.serving", "full"): {
        "flops": 180800716800, "k1": 1466368, "k3": 35389440},
    ("predict_zarr.serving", "tiny"): {
        "flops": 135851520, "k1": 831744, "k3": 1247616},
    ("predict_memm.baseline", "full"): {
        "flops": 192854097920, "k1": 1577216, "k3": 37748736},
    ("predict_memm.baseline", "tiny"): {
        "flops": 216760320, "k1": 1358976, "k3": 1990656},
    ("train_b16.fast_train", "full"): {"flops": 4628498350080, "k4": 3145728},
    ("train_b16.fast_train", "tiny"): {"flops": 385351680, "k4": 196608},
}

# every number the check works out has a limit here, so ``checks`` holds
# them all
ALL_LIMITS = {
    "predict": {"prob_gap_max": 9, "prob_gap_mean": 9, "mask_errors": 9,
                "output_errors": 9, "pixels_compared": 10 ** 12},
    "train": {"loss_gap": 9, "update_gap": 9, "grad_gap": 9},
}
CHECKS = {
    ("predict_zarr.serving", 11): {
        "prob_gap_max": 0.01212802529335022,
        "prob_gap_mean": 0.0010400970629176063, "mask_errors": 0,
        "output_errors": 0, "pixels_compared": 21506},
    ("predict_zarr.serving", 12345678901): {
        "prob_gap_max": 0.01292446255683899,
        "prob_gap_mean": 0.0010478432712949046, "mask_errors": 0,
        "output_errors": 0, "pixels_compared": 20786},
    ("predict_memm.baseline", 11): {
        "prob_gap_max": 0.013236165046691895,
        "prob_gap_mean": 0.0005065705516064503, "mask_errors": 0,
        "output_errors": 0, "pixels_compared": 20782},
    ("predict_memm.baseline", 12345678901): {
        "prob_gap_max": 0.005787760019302368,
        "prob_gap_mean": 0.0004637491653512337, "mask_errors": 0,
        "output_errors": 0, "pixels_compared": 21274},
    ("train_b16.fast_train", 11): {
        "loss_gap": 0.0010525017290081927, "grad_gap": 0.01370356214529679,
        "update_gap": 0.006706223139765143},
    ("train_b16.fast_train", 12345678901): {
        "loss_gap": 0.0007580914331413098, "grad_gap": 0.0700279988109791,
        "update_gap": 0.05217941459970576},
}


def _limits(cell):
    return ALL_LIMITS["train" if cell.startswith("train") else "predict"]


def _values(res):
    return {k: v["value"] for k, v in res["checks"].items()}


def _root_with(tmp_path, files, copy_dirs=()):
    """A run root under ``tmp_path`` holding ``files`` ({relative path:
    text}) and copies of the benchmark's ``copy_dirs``."""
    root = tmp_path / "root"
    for d in copy_dirs:
        for f in os.listdir(os.path.join(ROOT, "benchmark", d)):
            files.setdefault(f"benchmark/{d}/{f}", open(
                os.path.join(ROOT, "benchmark", d, f)).read())
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(root)


@pytest.fixture(scope="module")
def tiny_surveys(tmp_path_factory):
    out = {}
    for cell in ("predict_zarr.serving", "predict_memm.baseline"):
        spec = tiny_workload(cell)["survey"]
        folder = str(tmp_path_factory.mktemp(cell))
        out[cell] = predict_cell.reference_survey(
            spec, predict_cell.make_inputs(spec, folder, SURVEY_SEED))
    return out


@pytest.mark.parametrize("cell,size", sorted(COUNTS))
def test_counts_are_the_integers_of_the_harness_before_adapters(
        tiny_surveys, cell, size):
    cfg = run.cell_files(BENCH, cell)[3]
    if size == "tiny":
        cfg = dict(cfg, **TINY_CONFIG)
    arch = run.load_architecture(cfg)
    if cell.startswith("train"):
        B, (h, w) = int(cfg["batch_size"]), cfg["patch_size"]
        got = {"flops": arch.train_step_flops(cfg, B, h, w),
               "k4": counts.k4_bytes(B, h, w)}
    else:
        survey = tiny_surveys[cell]
        got = {"flops": predict_cell.useful_flops_per_pass(cfg, survey,
                                                           arch),
               **predict_cell.kernel_bytes_per_pass(cfg, survey, arch)}
    assert got == COUNTS[(cell, size)]


def test_adapter_forward_flops_analytic():
    cfg = run.cell_files(BENCH, "predict_memm.baseline")[3]
    arch = run.load_architecture(cfg)
    assert arch.forward_flops(cfg, 256, 256) == 96427048960
    assert arch.train_step_flops(cfg, 4, 256, 256) == 12 * 96427048960
    assert arch.slab_alignment(cfg) == 16 and arch.k3_channels(cfg) == 64


@pytest.mark.parametrize("cell,seed", sorted(CHECKS))
def test_tiny_checks_are_those_of_the_harness_before_adapters(
        tiny_run, cell, seed):
    res = tiny_run(cell, seed, limits=_limits(cell), seconds=0)
    assert _values(res) == CHECKS[(cell, seed)]


@pytest.mark.parametrize("cell", ["train_b16.fast_train",
                                  "predict_memm.baseline"])
def test_a_renamed_copy_of_the_adapter_enters_by_new_files_alone(
        tiny_run, tmp_path, cell):
    """A configuration, a workload and an adapter file, and their entries
    in the benchmark's list, run a cell of the copied architecture: its
    checks are the default's, bit for bit."""
    entry, conf, work, cfg = run.cell_files(BENCH, cell)
    name = entry["traffic"] + ".tiny_copy"
    tiny = dict(cfg, **TINY_CONFIG, name="tiny_copy",
                architecture="unet_copy", reduced=sorted(TINY_CONFIG))
    root = _root_with(tmp_path, {
        "benchmark/configs/tiny_copy.json": json.dumps(tiny),
        f"benchmark/workloads/{name}.json": json.dumps(work),
        "benchmark/architectures/unet_copy.py": open(UNET).read()})
    bench = copy.deepcopy(BENCH)
    bench["configs"].append(dict(conf, name="tiny_copy",
                                 file="benchmark/configs/tiny_copy.json",
                                 reduced=tiny["reduced"]))
    bench["workloads"].append(dict(entry, name=name, config="tiny_copy"))
    got = run.run_cell(bench, name, 11, 0, 0, device="cpu", root=root,
                       overrides={"workload": dict(tiny_workload(cell),
                                                   limits=_limits(cell))})
    want = tiny_run(cell, 11, limits=_limits(cell), seconds=0)
    assert _values(got) == _values(want) == CHECKS[(cell, 11)]


def test_a_slab_cell_of_an_architecture_without_slab_mode_stops(
        tiny_run, tmp_path):
    noslab = open(UNET).read() + (
        "\n\ndef slab_alignment(cfg):\n    return None\n")
    root = _root_with(tmp_path,
                      {"benchmark/architectures/noslab.py": noslab},
                      copy_dirs=("configs", "workloads"))
    path = os.path.join(root, "benchmark", "architectures", "noslab.py")
    with pytest.raises(SystemExit, match=re.escape(path) + " gives no slab"):
        tiny_run("predict_zarr.serving", 1, limits=_limits("predict"),
                 config={"architecture": "noslab"}, root=root)


@pytest.mark.parametrize("name,message", [
    ("no_such_arch", re.escape(os.path.join(
        ROOT, "benchmark", "architectures", "no_such_arch.py"))
     + " does not exist"),
    ("../architectures/unet", "is not a plain name"),
])
def test_an_architecture_without_its_file_stops_the_run(tiny_run, name,
                                                        message):
    with pytest.raises(SystemExit, match=message):
        tiny_run("predict_memm.baseline", 1, limits=_limits("predict"),
                 config={"architecture": name})
