"""Zarr gridded evaluation: the port against the JAX package.

The same zarr survey (one copy per package) and the same weights go
through the JAX ``evaluate_reader`` and the port's on the CPU (the port's
kernels run their plain versions), in every eval mode and transfer dtype,
and on a survey whose labels hold NaN (the range pad of a store, and
holes beside its schools), which both packages score as boundary.
Stated tolerance: per-class pixel counts identical (integer label
algebra); max-F1 and average precision within 2e-3 (float32 sums in
another order move a score by a float16 ulp, which shifts its bin).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crimac_unet_tpu.data.fixtures import make_zarr_survey
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
from crimac_unet_tpu.data.zarrlite import ZGroup
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    evaluate_reader as jax_evaluate_reader
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

H, W, SEED = 120, 300, 37
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
       "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1}


def _nan_labels(sv):
    """Write NaN into a store's annotation masks: the bottom 12 range rows
    of every ping (a range pad) and a band beside the first school."""
    ann = ZGroup.open(os.path.join(os.path.dirname(sv),
                                   "S2017843_labels.zarr"))["annotation"]
    masks = ann[:]
    masks[:, :, H - 12:] = np.nan
    ping, rng = np.nonzero(masks[-1] > 0)
    masks[:, ping[0]:ping[0] + 30, max(rng[0] - 6, 0):rng[0]] = np.nan
    ann[:] = masks


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("zarreval")
    out = {}
    for who in ("jax", "port", "nan_jax", "nan_port"):
        out[who] = make_zarr_survey(root / who, year=2017, n_echograms=1,
                                    H=H, W=W, seed=SEED, unused_species=True)
    for who in ("nan_jax", "nan_port"):
        _nan_labels(out[who])
    out["nested"] = root / "nested"
    make_zarr_survey(out["nested"], year=2017, n_echograms=1, H=H, W=W,
                     seed=SEED, unused_species=True, layout="nested")
    return out


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(12), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(12)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


def _curve_scores(hist):
    curve = metrics.pr_curve_from_histogram(hist)
    ap = -np.sum(np.diff(curve["recall"]) * curve["precision"][:-1])
    return metrics.max_f1(curve)[0], ap


def _eval_both(surveys, variables, eval_mode, transfer, jax_key="jax",
               port_key="port"):
    model, v = variables
    cfg = dict(CFG, transfer_dtype=transfer)
    want = np.asarray(jax_evaluate_reader(
        JaxRunner(model, v, cfg), JaxReader(surveys[jax_key]),
        jax_metrics.new_histogram(), eval_mode=eval_mode, chunk_cols=3))
    runner = GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v), cfg,
                           device="cpu")
    got = evaluate_reader(runner, DataReaderZarr(surveys[port_key]),
                          metrics.new_histogram(), eval_mode=eval_mode,
                          chunk_cols=3)
    return got, want, runner


def _assert_hist_close(got, want):
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert want[0].sum() > 0 and want[1].sum() > 0
    (f_got, ap_got), (f_want, ap_want) = _curve_scores(got), \
        _curve_scores(want)
    assert abs(f_got - f_want) < 2e-3, (f_got, f_want)
    assert abs(ap_got - ap_want) < 2e-3, (ap_got, ap_want)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("eval_mode", ["all", "region", "trace"])
def test_zarr_eval_matches_jax(surveys, variables, eval_mode, transfer):
    got, want, runner = _eval_both(surveys, variables, eval_mode, transfer)
    _assert_hist_close(got, want)
    # 300 pings -> 7 grid columns in groups of 3, 3 and 1; the seeded
    # seabed -> 3 grid rows: 9, 9 and 3 patches, 2 + 2 + 1 sub-batches
    assert runner.forwards == 5


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
def test_zarr_eval_nan_labels_match_jax(surveys, variables, transfer):
    """NaN labels are boundary on the host before any integer cast: the
    counts match the JAX package's and differ from the survey without
    NaN (scoring the pad as background would add negatives)."""
    got, want, _ = _eval_both(surveys, variables, "all", transfer,
                              "nan_jax", "nan_port")
    _assert_hist_close(got, want)
    clean, _, _ = _eval_both(surveys, variables, "all", transfer)
    assert got.sum() < clean.sum(), (got.sum(1), clean.sum(1))


def test_zarr_eval_differs_from_memmap_laws(surveys, variables,
                                            monkeypatch):
    """The zarr path takes the zarr seabed law and no border zeroing:
    forcing the memmap laws onto the same survey changes the counts."""
    _, v = variables
    cfg = dict(CFG, transfer_dtype="float32")
    runner = GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v), cfg,
                           device="cpu")
    reader = DataReaderZarr(surveys["port"])
    zarr_hist = evaluate_reader(runner, reader, metrics.new_histogram(),
                                chunk_cols=3)
    real = runner._eval_patches

    def memmap_laws(*args, **kw):
        kw["zarr_pad"] = False
        return real(*args, **kw)
    monkeypatch.setattr(runner, "_eval_patches", memmap_laws)
    memm_hist = evaluate_reader(runner, reader, metrics.new_histogram(),
                                chunk_cols=3)
    assert not np.array_equal(zarr_hist, memm_hist)


def test_zarr_evaluate_cli_matches_jax_curve(surveys, variables, tmp_path):
    """The evaluation CLI with ``data_mode: zarr`` on a nested survey root
    writes the curve of ``evaluate_reader`` on the JAX package's side."""
    import pandas as pd
    import yaml
    from crimac_unet_tpu_torch.pipeline.evaluate import main
    model, v = variables
    ckpt = tmp_path / "run0" / "model.pt"
    ckpt.parent.mkdir()
    save_torch_checkpoint(v, ckpt)
    cfg = dict(CFG, data_mode="zarr", path_to_zarr_files=str(
        surveys["nested"]), partition_predict="selected surveys",
        evaluation_surveys=[2017], eval_mode="all",
        transfer_dtype="float32", random_seed=3)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    main(["--yaml_path", str(tmp_path / "cfg.yaml"), "--checkpoint_path",
          str(ckpt), "--save_path_metrics", str(tmp_path / "metrics"),
          "--save_path_plot", str(tmp_path / "plots"), "--device", "cpu"])
    got = pd.read_csv(tmp_path / "metrics" / "cfg" / "run0" /
                      "2017_test.csv", index_col=0)
    want = np.asarray(jax_evaluate_reader(
        JaxRunner(model, v, cfg), JaxReader(surveys["jax"]),
        jax_metrics.new_histogram(), eval_mode="all"))
    curve = metrics.pr_curve_from_histogram(want)
    assert len(got) == len(curve["precision"])
    assert abs(got["F1"].max() - metrics.max_f1(curve)[0]) < 2e-3
