"""Memmap gridded evaluation: the port against the JAX package.

The same synthetic survey (one copy per package, so each computes its own
seabed and heave-reverted labels) and the same weights go through the JAX
``evaluate_reader`` and the port's on the CPU (the port's kernels run their
plain versions).  Stated tolerance: per-class pixel counts identical (the
label chain is integer algebra); max-F1 and average precision within 2e-3,
as tests/test_eval_parity.py allows, because float32 convolutions summed in
another order move a score by a float16 ulp, which shifts its bin.
"""

import csv
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from crimac_unet_tpu.data.fixtures import make_survey_dir
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    _build_keep_mask as jax_build_keep_mask
from crimac_unet_tpu.pipeline.inference import \
    evaluate_reader as jax_evaluate_reader
from crimac_unet_tpu.pipeline.segpipe import \
    save_metrics_dict as jax_save_metrics_dict
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.pipeline.eval_gridded import (_build_keep_mask,
                                                         evaluate_reader)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

H, W, SEED = 120, 300, 17
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
       "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1}


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalmemm")
    dirs = {}
    for who in ("jax", "port", "cli", "nan_jax", "nan_port"):
        make_survey_dir(root / who, year=2017, n_echograms=1, H=H, W=W,
                        seed=SEED, unused_species=True)
        dirs[who] = root / who
    for who in ("nan_jax", "nan_port"):
        _float_labels_with_nan(next(dirs[who].iterdir()))
    return dirs


def _float_labels_with_nan(folder):
    """Rewrite an echogram's labels as a float32 memmap holding NaN (and a
    fractional code) inside and beside its schools."""
    lab = np.fromfile(folder / "labels.dat", np.int16).reshape(H, W)
    lab = lab.astype(np.float32)
    ys, xs = np.nonzero(lab > 0)
    pick = np.random.RandomState(3).choice(len(ys), len(ys) // 4,
                                           replace=False)
    lab[ys[pick], xs[pick]] = np.nan
    lab[5:9, 10:60] = np.nan
    lab[ys[:5], xs[:5]] = 27.5
    lab.tofile(folder / "labels.dat")
    with open(folder / "label_dtype.pkl", "wb") as f:
        pickle.dump("float32", f, protocol=2)


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(9), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(9)
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
        JaxRunner(model, v, cfg), JaxEchogram(next(surveys[jax_key].iterdir())),
        jax_metrics.new_histogram(), eval_mode=eval_mode, chunk_cols=3))
    runner = GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v), cfg,
                           device="cpu")
    got = evaluate_reader(runner, Echogram(next(surveys[port_key].iterdir())),
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


@pytest.mark.parametrize("eval_mode", ["all", "region", "trace"])
def test_eval_matches_jax_float32(surveys, variables, eval_mode):
    got, want, runner = _eval_both(surveys, variables, eval_mode, "float32")
    _assert_hist_close(got, want)
    # 300 pings -> 7 grid columns in groups of 3, 3 and 1; the seeded
    # seabed -> 3 grid rows: 9, 9 and 3 patches, 2 + 2 + 1 sub-batches
    assert runner.forwards == 5


@pytest.mark.parametrize("transfer", ["bfloat16", "uint8"])
def test_eval_matches_jax_quantized_transfer(surveys, variables, transfer):
    got, want, _ = _eval_both(surveys, variables, "region", transfer)
    _assert_hist_close(got, want)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
def test_eval_float_labels_with_nan_match_jax(surveys, variables, transfer):
    """A float32 label memmap holding NaN: XLA's int32 cast maps NaN to 0
    (BACKGROUND) on the float32 path, the host conversion to IGNORE on
    the quantized one; the port follows each."""
    got, want, _ = _eval_both(surveys, variables, "all", transfer,
                              "nan_jax", "nan_port")
    _assert_hist_close(got, want)


def test_eval_chains_incoming_histogram(surveys, variables):
    """evaluate_reader adds onto an incoming histogram (a survey's readers
    chain), whether it is the int32 start or an int64 total."""
    _, v = variables
    runner = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v),
                           dict(CFG, transfer_dtype="float32"), device="cpu")
    reader = Echogram(next(surveys["port"].iterdir()))
    once = evaluate_reader(runner, reader, metrics.new_histogram(),
                           chunk_cols=3)
    twice = evaluate_reader(runner, reader, once, chunk_cols=3)
    np.testing.assert_array_equal(twice, 2 * once)


@pytest.mark.parametrize("eval_mode", ["region", "trace"])
@pytest.mark.parametrize("pad", [0, 8, (12, 40)])
def test_build_keep_mask_bit_equal(surveys, eval_mode, pad):
    reader = Echogram(next(surveys["port"].iterdir()))
    jreader = JaxEchogram(next(surveys["jax"].iterdir()))
    got = _build_keep_mask(reader, eval_mode, 20, H, W, pad=pad)
    want = jax_build_keep_mask(jreader, eval_mode, 20, H, W, pad=pad)
    assert got.dtype == np.bool_ and got.any()
    np.testing.assert_array_equal(got, want)


def test_eval_cli_csv_matches_jax_writer(surveys, variables, tmp_path,
                                         monkeypatch):
    """The port's CLI (--device cpu) writes the metrics CSV and the PR
    plot; the CSV parses to the columns and numbers the JAX package's
    pandas writer gives for the same curve."""
    import yaml
    from crimac_unet_tpu_torch.pipeline.evaluate import main

    _, v = variables
    ckpt = tmp_path / "run0" / "model.pt"
    ckpt.parent.mkdir()
    save_torch_checkpoint(v, ckpt)
    cfg = dict(CFG, data_mode="memm", partition_predict="selected surveys",
               evaluation_surveys=[2017], eval_mode="fish",
               transfer_dtype="float32", random_seed=3)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "setpyenv.json").write_text(
        '{"path_to_echograms": "%s"}' % surveys["cli"])
    monkeypatch.setenv("CRIMAC_SETPYENV", str(tmp_path / "setpyenv.json"))
    main(["--yaml_path", str(tmp_path / "cfg.yaml"), "--checkpoint_path",
          str(ckpt), "--save_path_metrics", str(tmp_path / "metrics"),
          "--save_path_plot", str(tmp_path / "plots"), "--device", "cpu"])
    out = tmp_path / "metrics" / "cfg" / "run0" / "2017_test.csv"
    assert (tmp_path / "plots" / "cfg" / "run0" / "2017_pr.png").is_file()

    # the same curve, recomputed, through the JAX package's writer
    runner = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v),
                           dict(CFG, transfer_dtype="float32"),
                           device="cpu")
    hist = evaluate_reader(runner,
                           Echogram(next(surveys["cli"].iterdir())),
                           metrics.new_histogram(), eval_mode="trace")
    jax_save_metrics_dict(metrics.pr_curve_from_histogram(hist),
                          tmp_path / "jax.csv")
    got, want = pd.read_csv(out), pd.read_csv(tmp_path / "jax.csv")
    assert list(got.columns) == list(want.columns) == [
        "Unnamed: 0", "precision", "recall", "thresholds", "F1"]
    pd.testing.assert_frame_equal(got, want)
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "precision", "recall", "thresholds", "F1"]
    assert rows[-1][3] == ""                  # the trailing NaN threshold
    assert os.path.getsize(out) > 0


def test_eval_rejects_unported_paths(surveys, variables):
    """The static grid (fixed_R) is ported and histogram-exact; metadata
    evaluation of a zarr reader is rejected, as the reference's zarr crop
    path carries no metadata."""
    from types import SimpleNamespace

    from crimac_unet_tpu_torch.pipeline.runner import _build_meta_inputs
    _, v = variables
    runner = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v),
                           dict(CFG, transfer_dtype="float32"), device="cpu")
    reader = Echogram(next(surveys["port"].iterdir()))
    own = evaluate_reader(runner, reader, metrics.new_histogram(),
                          chunk_cols=3)
    padded = evaluate_reader(runner, reader, metrics.new_histogram(),
                             chunk_cols=3, fixed_R=6)
    np.testing.assert_array_equal(padded, own)
    zarr = SimpleNamespace(data_format="zarr")
    with pytest.raises(ValueError, match="memmap-only"):
        _build_meta_inputs(SimpleNamespace(meta_channels={}, window=(64, 64)),
                           zarr, 64, 64, -8, -8, np.zeros(1))


def test_save_pr_plot_names_matplotlib_when_missing(monkeypatch, tmp_path):
    import builtins

    from crimac_unet_tpu_torch.pipeline.segpipe import save_pr_plot
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        save_pr_plot({"recall": [0.0], "precision": [1.0]},
                     tmp_path / "pr.png")

