"""Tests of the benchmark harness, on the CPU at tiny sizes.

    python -m pytest benchmark/tests -q

Tests marked ``gpu`` run a cell on the card and skip without one; the
decision is made inside a fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {"depth": 2, "start_filts": 4, "patch_size": [64, 64],
               "patch_overlap": 10, "preload_n_pings": 100, "fwd_batch": 8,
               "num_workers": 2}


def tiny_workload(cell):
    if cell.startswith("train"):
        return {"survey": {"format": "memm", "n_range": 120, "n_pings": 600,
                           "validation_pings": 300,
                           "train_years": [2011, 2013],
                           "validation_years": [2017],
                           "schools_per_4000": 24},
                "warm_steps": 2, "trace_steps": 4}
    fmt = "zarr" if "zarr" in cell else "memm"
    return {"survey": {"format": fmt, "year": 2017, "n_range": 120,
                       "n_pings": 300, "n_schools": 3},
            "check_chunks": 3, "trace_passes": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs a cell on the card")
    return "cuda"


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """``tiny_run(cell, seed, ...)``: one run of ``cell`` on the CPU at a
    tiny size, the harness's look for a card skipped; the program writes
    zlib stores, as on the card's host (no Blosc backend there)."""
    from benchmark import run
    from crimac_unet_tpu_torch.data import blosc_codec
    monkeypatch.setattr(run, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(blosc_codec, "_chunkio", False)
    monkeypatch.setattr(blosc_codec, "_libblosc", False)
    bench = run.load_bench()

    def go(cell, seed, trace=0, fault=None, control=False, limits=None,
           workload=None, seconds=0.5, config=None, root=run.ROOT):
        work = dict(tiny_workload(cell), **(workload or {}))
        if limits is not None:
            work["limits"] = limits
        return run.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                            overrides={"config": dict(TINY_CONFIG,
                                                      **(config or {})),
                                       "workload": work},
                            fault=fault, control=control, root=root)
    return go
