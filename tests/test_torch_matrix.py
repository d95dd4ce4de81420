"""The configuration matrix of ``tests/test_matrix.py``, the port against
the JAX package.

The JAX package pins its deep knob combinations (the ones production
configs run: ``config_serving.yaml`` turns four knobs at once) against
its exact baseline (patch + float32 transfer + float16 output +
per-chunk grids).  Here each combination runs through the JAX package
and through the port on the same seeded surveys (one copy per package)
and the same weights, at the JAX test's size: depth 2, start_filts 4,
patch 32, overlap 4, three chunks a survey.  The port runs on the CPU,
where its kernels take their plain versions.

Each combination is held twice:

- to the JAX package's same combination, at the tolerance of the port's
  pairwise parity tests for these knobs (``tests/test_torch_serving.py``,
  ``tests/test_torch_zarr_predict.py``): the same chunks, the written zero
  set identical, probabilities within 2 float16 ulp (float32
  convolutions summed in another order); evaluation per-class pixel
  counts identical and max-F1 within 2e-3 (``tests/test_torch_zarr_eval
  .py``);
- to the port's own baseline under the JAX test's mask law and mean and
  max bounds for that combination (the bounds of ``tests/test_matrix.py``,
  copied with their names).

The mesh stack runs the serving stack on two gloo ranks (this file,
spawned as ``python tests/test_torch_matrix.py <rank> 2 <port> <dir>``)
with ``mesh_devices: 2``.  The slab's ping axis splits over the ranks
with its halo, whose float32 outputs agree with one rank's within 2e-5
(``tests/test_torch_multirank.py``), so a uint8 output code may move by
one step: each rank is held to one rank, and to the JAX package's
8-device mesh, within 1/255 + 1e-3 (the JAX test's bound where its mesh
is not bit-identical).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.data.fixtures import (make_survey_dir,
                                                 make_zarr_survey)
from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
from crimac_unet_tpu_torch.data.meta_channels import get_in_channels
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import (flax_to_torch_state_dict,
                                                  to_tensors)
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.parallel import mesh as pmesh
from crimac_unet_tpu_torch.parallel.multihost_check import (free_port,
                                                            run_ranks)
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.predict import predict_reader
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

WH = WW = 32
OVERLAP = 4          # stride 24; depth 2 -> alignment 2: slab-aligned
PRELOAD = 70         # zarr survey W=160 -> 3 chunks (the tail chunk too)
TIMEOUT = 240        # each spawned rank

BASE_CFG = {"patch_size": [WH, WW], "patch_overlap": OVERLAP,
            "frequencies": [18, 38, 120, 200], "fwd_batch": 8,
            "depth": 2, "start_filts": 4,
            "transfer_dtype": "float32", "output_dtype": "float16",
            "infer_mode": "patch", "static_grid": False}
PORT_CFG = dict(BASE_CFG, compute_dtype="float32", mesh_devices=1,
                device="cpu", alignment_warning=False)
SERVING = dict(infer_mode="slab", static_grid=True, transfer_dtype="uint8",
               output_dtype="uint8")
META = {"portion_year": True, "portion_day": False, "depth_rel": True,
        "depth_abs_surface": True, "depth_abs_seabed": True,
        "time_diff": True}
MESH_ATOL = 1 / 255 + 1e-3

# (name, overrides, mask law, mean bound, max bound): tests/test_matrix.py
# COMBOS, whose comments cite each bound's source
COMBOS = [
    ("bf16-static", dict(transfer_dtype="bfloat16", static_grid=True),
     "equal", 5e-3, 0.08),
    ("u8in-static", dict(transfer_dtype="uint8", static_grid=True),
     "equal", 0.01, 0.15),
    ("u8out-static", dict(output_dtype="uint8", static_grid=True),
     "grow-small", 2e-3, 0.5 / 255 + 1e-3),
    ("u8in-u8out", dict(transfer_dtype="uint8", output_dtype="uint8"),
     "grow-small", 0.012, 0.16),
    ("slab-static", dict(infer_mode="slab", static_grid=True),
     "equal", 0.02, 0.6),
    ("slab-bf16", dict(infer_mode="slab", transfer_dtype="bfloat16"),
     "equal", 0.02, 0.6),
    ("serving-stack", SERVING, "grow-small", 0.03, 0.65),
    ("serving-stack-patch", dict(static_grid=True, transfer_dtype="uint8",
                                 output_dtype="uint8"),
     "grow-small", 0.012, 0.16),
]


def _make_surveys(root, make_zarr, make_memm):
    sv = make_zarr(root / "zarr", year=2017, n_echograms=1, H=90, W=160,
                   seed=41, n_schools=4)
    make_memm(root / "memm", year=2017, n_echograms=2, H=90, W=80, seed=43,
              n_schools=3)
    return sv, root / "memm"


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """{package: (zarr reader, [memmap readers])}, one copy each."""
    from crimac_unet_tpu.data import fixtures as jfix
    from crimac_unet_tpu.data.memmap_reader import \
        get_echograms as jax_get_echograms
    from crimac_unet_tpu.data.zarr_reader import \
        DataReaderZarr as JaxReader
    root = tmp_path_factory.mktemp("matrix")
    out = {}
    for who, make_zarr, make_memm, zr, ge in (
            ("jax", jfix.make_zarr_survey, jfix.make_survey_dir, JaxReader,
             jax_get_echograms),
            ("port", make_zarr_survey, make_survey_dir, DataReaderZarr,
             get_echograms)):
        sv, memm = _make_surveys(root / who, make_zarr, make_memm)
        out[who] = (zr(str(sv)), ge(years=[2017], path_to_echograms=str(memm),
                                    minimum_shape=WH))
    out["root"] = root
    return out


def _flax_variables(cfg, seed, meta_channels=0, late=False):
    import jax
    import jax.numpy as jnp

    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    model = jax_build_unet(cfg)
    x = jnp.zeros((1, WH, WW, 4 + (0 if late else meta_channels)))
    meta = jnp.zeros((1, WH, WW, meta_channels)) if late else None
    kw = {"meta": meta} if late else {}
    v = model.init(jax.random.PRNGKey(seed), x, train=False, **kw)
    return model, jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def weights():
    """The JAX test's weights (PRNGKey 3) and their state dict."""
    model, v = _flax_variables(BASE_CFG, 3)
    return model, v, flax_to_torch_state_dict(v)


def _port_predict(state_dict, reader, cfg):
    runner = GriddedRunner(build_unet(cfg), state_dict, cfg, device="cpu")
    return [(s, e, np.asarray(p, np.float32))
            for s, e, p, _ in predict_reader(runner, reader, PRELOAD)]


def _jax_predict(model, v, reader, cfg):
    from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
    from crimac_unet_tpu.pipeline.inference import \
        predict_reader as jax_predict_reader
    return [(s, e, np.asarray(p, np.float32)) for s, e, p, _ in
            jax_predict_reader(JaxRunner(model, v, cfg), reader, PRELOAD)]


def assert_matches_jax(got, want, name, atol=None):
    """The port's chunks against the JAX package's: the same chunks, the
    same zero set, probabilities within 2 float16 ulp (or ``atol``)."""
    assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want], name
    for (_, _, p), (_, _, q) in zip(got, want):
        assert p.shape == q.shape, name
        np.testing.assert_array_equal(p == 0, q == 0, err_msg=name)
        assert (q != 0).any(), name
        tol = 2 * np.spacing(np.maximum(np.abs(p), np.abs(q)).astype(
            np.float16)).astype(np.float32) if atol is None else atol
        bad = np.abs(p - q) > tol
        assert not bad.any(), (name, int(bad.sum()), np.abs(p - q).max())


def assert_combo(base, out, name, mask_law, mean_tol, max_tol):
    """A combination against the exact baseline, chunk by chunk: the
    mask law and the mean and max bounds of tests/test_matrix.py."""
    assert len(out) == len(base) > 1, name
    for (s, e, p0), (s2, e2, p1) in zip(base, out):
        assert (s2, e2) == (s, e), name
        assert np.isfinite(p1).all(), name
        z0, z1 = p0 == 0, p1 == 0
        if mask_law == "equal":
            np.testing.assert_array_equal(z0, z1, err_msg=name)
        else:  # "grow-small": the uint8 output's zero set may only grow,
            # by pixels inside the quantization envelope
            assert (p1[z0] == 0).all(), name
            extra = z1 & ~z0
            if extra.any():
                assert p0[extra].max() < max_tol + 0.5 / 255 + 1e-3, \
                    (name, p0[extra].max())
        written = ~z0 & ~z1
        assert written.any(), name
        d = np.abs(p0 - p1)[written]
        assert d.mean() <= mean_tol, (name, d.mean())
        assert d.max() <= max_tol, (name, d.max())


@pytest.fixture(scope="module")
def zarr_baseline(surveys, weights):
    _, _, sd = weights
    return _port_predict(sd, surveys["port"][0], PORT_CFG)


@pytest.mark.parametrize("name,ov,mask_law,mean_tol,max_tol", COMBOS,
                         ids=[c[0] for c in COMBOS])
def test_zarr_combo_matrix(surveys, weights, zarr_baseline, name, ov,
                           mask_law, mean_tol, max_tol):
    model, v, sd = weights
    got = _port_predict(sd, surveys["port"][0], dict(PORT_CFG, **ov))
    want = _jax_predict(model, v, surveys["jax"][0], dict(BASE_CFG, **ov))
    assert_matches_jax(got, want, name)
    assert_combo(zarr_baseline, got, name, mask_law, mean_tol, max_tol)


def test_zarr_baseline_matches_jax(surveys, weights, zarr_baseline):
    model, v, _ = weights
    assert_matches_jax(zarr_baseline, _jax_predict(
        model, v, surveys["jax"][0], BASE_CFG), "baseline")


def test_zarr_static_grid_bit_identical_on_cpu(surveys, weights,
                                               zarr_baseline):
    """The static grid alone (patch mode) reproduces the baseline bit for
    bit on the CPU, as in the JAX package."""
    _, _, sd = weights
    out = _port_predict(sd, surveys["port"][0],
                        dict(PORT_CFG, static_grid=True))
    for (_, _, p0), (_, _, p1) in zip(zarr_baseline, out):
        np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("i", [0, 1])
def test_memm_serving_stack(surveys, weights, i):
    """The serving stack on each memmap echogram: the border and the
    per-echogram grids under the static grid and uint8 both ways."""
    model, v, sd = weights
    ech, jech = surveys["port"][1][i], surveys["jax"][1][i]
    base = _port_predict(sd, ech, PORT_CFG)
    out = _port_predict(sd, ech, dict(PORT_CFG, **SERVING))
    assert_matches_jax(out, _jax_predict(model, v, jech,
                                         dict(BASE_CFG, **SERVING)),
                       "memm-serving-stack")
    assert_combo(base, out, "memm-serving-stack", "grow-small", 0.03, 0.65)


@pytest.mark.parametrize("late", [False, True],
                         ids=["early-meta", "late-meta"])
def test_meta_serving_stack(surveys, late):
    """Metadata models (early and late inject) under slab + static grid
    + uint8 transfer."""
    cfg = dict(BASE_CFG, meta_channels=META, late_meta_inject=late)
    model, v = _flax_variables(cfg, 9, get_in_channels(META), late)
    sd = flax_to_torch_state_dict(v)
    pcfg = dict(PORT_CFG, meta_channels=META, late_meta_inject=late)
    stack = dict(infer_mode="slab", static_grid=True, transfer_dtype="uint8")
    ech, jech = surveys["port"][1][0], surveys["jax"][1][0]
    base = _port_predict(sd, ech, pcfg)
    out = _port_predict(sd, ech, dict(pcfg, **stack))
    assert_matches_jax(base, _jax_predict(model, v, jech, cfg), "meta base")
    assert_matches_jax(out, _jax_predict(model, v, jech, dict(cfg, **stack)),
                       f"meta-serving late={late}")
    assert_combo(base, out, f"meta-serving late={late}", "equal", 0.03,
                 0.65)


@pytest.mark.parametrize("eval_mode", ["all", "region", "trace"])
def test_eval_mode_transfer_dtype_matrix(surveys, weights, eval_mode):
    """Evaluation in every eval mode with float32 and uint8 transfer:
    each histogram against the JAX package's, and the two transfers'
    per-class counts identical with max-F1 within 0.05 (the JAX
    test's law)."""
    from crimac_unet_tpu.ops import metrics as jax_metrics
    from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
    from crimac_unet_tpu.pipeline.inference import \
        evaluate_reader as jax_evaluate_reader
    model, v, sd = weights
    f1 = {}
    hists = {}
    for td in ("float32", "uint8"):
        cfg = dict(PORT_CFG, transfer_dtype=td)
        runner = GriddedRunner(build_unet(cfg), sd, cfg, device="cpu")
        h = np.asarray(evaluate_reader(
            runner, surveys["port"][0], metrics.new_histogram(),
            eval_mode=eval_mode, chunk_cols=4)).astype(np.int64)
        jh = np.asarray(jax_evaluate_reader(
            JaxRunner(model, v, dict(BASE_CFG, transfer_dtype=td)),
            surveys["jax"][0], jax_metrics.new_histogram(),
            eval_mode=eval_mode, chunk_cols=4)).astype(np.int64)
        np.testing.assert_array_equal(h.sum(axis=1), jh.sum(axis=1))
        f1[td], _ = metrics.max_f1(metrics.pr_curve_from_histogram(h))
        jf1, _ = jax_metrics.max_f1(jax_metrics.pr_curve_from_histogram(jh))
        assert abs(f1[td] - jf1) < 2e-3, (td, f1[td], jf1)
        hists[td] = h
    assert hists["float32"].sum() > 0
    np.testing.assert_array_equal(hists["float32"].sum(axis=1),
                                  hists["uint8"].sum(axis=1))
    assert abs(f1["float32"] - f1["uint8"]) < 0.05, f1


# ------------------------------------------------------------ mesh stack
def _mesh_worker(rank, world, port, work):
    """One rank of the mesh serving stack: the zarr survey with
    ``mesh_devices: 2``; each rank keeps its chunks."""
    torch.set_num_threads(1)
    pmesh.init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank, device="cpu",
                           timeout_s=TIMEOUT)
    try:
        sd = torch.load(work / "weights.pt", weights_only=True)
        reader = DataReaderZarr(str(json.loads(
            (work / "survey.json").read_text())))
        out = _port_predict(sd, reader, dict(PORT_CFG, mesh_devices=world,
                                             **SERVING))
        np.savez(work / f"mesh_r{rank}.npz",
                 **{f"{s}_{e}": p for s, e, p in out})
    finally:
        pmesh.shutdown_distributed()


def test_mesh_serving_stack(surveys, weights, tmp_path):
    """The serving stack over two ranks against one rank and against the
    JAX package's 8-device mesh."""
    import jax
    model, v, sd = weights
    reader, jreader = surveys["port"][0], surveys["jax"][0]
    torch.save(to_tensors(sd), tmp_path / "weights.pt")
    (tmp_path / "survey.json").write_text(json.dumps(reader.sv_path))
    port = free_port()
    run_ranks(lambda r: [sys.executable, __file__, str(r), "2", str(port),
                         str(tmp_path)], 2, TIMEOUT)
    single = _port_predict(sd, reader, dict(PORT_CFG, **SERVING))
    want = None
    if len(jax.devices()) >= 8:
        want = _jax_predict(model, v, jreader, dict(BASE_CFG, mesh_devices=8,
                                                    **SERVING))
    for rank in (0, 1):
        got = np.load(tmp_path / f"mesh_r{rank}.npz")
        chunks = sorted((*map(int, k.split("_")), got[k])
                        for k in got.files)
        assert_matches_jax(chunks, single, f"mesh rank {rank}",
                           atol=MESH_ATOL)
        if want is not None:
            assert_matches_jax(chunks, want, f"mesh rank {rank} vs JAX",
                               atol=MESH_ATOL)


if __name__ == "__main__":
    _mesh_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                 Path(sys.argv[4]))
