"""BENCHMARK.json against the files it names, the contract's name and
unit rules, the frozen counts, and run.py's refusal without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.yardstick import counts

from .conftest import ROOT

BENCH = run.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1] == "benchmark/run.py"
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_workload_found_by_name(cell):
    entry, conf, work, cfg = run.cell_files(BENCH, cell)
    assert entry["chips"] == 1
    assert work["kind"] in ("predict_zarr", "predict_memm", "train")
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert work["limits"], "every cell's check has limits"


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert conf["reduced"] == cfg["reduced"]
    assert cfg["source"] == conf["source"]
    run.load_architecture(cfg).check_config(cfg)
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("conf", ["baseline", "serving", "fast_train"])
def test_frozen_preset_equals_its_source(conf):
    """The frozen copy holds every key of the port's preset at the commit
    it names, with the same value."""
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, "benchmark", "configs",
                           conf + ".json")) as f:
        cfg = json.load(f)
    assert "d20381e" in cfg["copied_from"]
    path = os.path.join(ROOT, cfg["copied_from"].split()[0])
    with open(path) as f:
        src = yaml.safe_load(f)
    for k, v in src.items():
        assert cfg[k] == v, k


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert callable(run.load_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS), \
            "a cell reports a per-layer metric without the metric it moves"


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_names_and_units(m):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        allowed.add("bound")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200
    assert set(m) <= allowed
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")


def test_every_name_and_file_name():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = run.metrics_of(BENCH, cell, 0)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = run.metrics_of(BENCH, cell, 1)
    assert layer
    for m in layer:
        assert m["moves"] in names


def test_forward_flops_analytic():
    # the batch-32 forward is 96.43 GFLOP a patch
    assert counts.unet_forward_flops(256, 256) == 96427048960
    assert counts.train_step_flops(4, 256, 256) == 12 * 96427048960


def test_kernel_bytes_analytic():
    # K1: a (1120, 1120, 4) uint8 slab read, a bfloat16 (1, 1120, 1120,
    # 4) window written; K3: (1, 1120, 1120, 64) bfloat16 read, skip and
    # pooled written; K4: three (4, 256, 256) bool masks
    assert counts.k1_bytes(1120, 1120, 4, 1, 1, 1120, 1120) == \
        1120 * 1120 * 4 * (1 + 2)
    assert counts.k3_bytes(1, 1120, 1120, 64) == \
        1120 * 1120 * 64 * 2 * 2 + 560 * 560 * 64 * 2
    assert counts.k4_bytes(4, 256, 256) == 3 * 4 * 256 * 256


def test_run_fails_without_a_card(tmp_path):
    """run.py exits non-zero and prints no result where no CUDA device is
    visible; it does not fall back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
