"""School-detection evaluation: the port against the JAX package.

The detector, matching and AP run on the same numpy arrays in both
packages; ``school_eval_survey`` runs from the same written prediction
stores (exact: the inputs are the same float16 values) and live, through
each package's own predict path on the CPU (the port's kernels run their
plain versions) with the same weights.  Stated tolerance of the live runs:
the probability threshold is chosen where no stored probability of either
package lies within 2 float16 ulp of it, so no pixel can flip; detection
boxes, pixel counts and AP are then equal, and scores (mean probabilities)
agree within 2e-3.  Both CSVs are the JAX package's pandas text.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crimac_unet_tpu.pipeline.school_eval as J
import crimac_unet_tpu_torch.pipeline.school_eval as P
from crimac_unet_tpu.data.fixtures import make_survey_dir, make_zarr_survey
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxZarrReader
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.pipeline.predict import (
    save_reader_predictions_memm, save_survey_predictions_zarr)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

H, W, SEED, PRELOAD = 100, 240, 3, 80
CFG = {"patch_size": [32, 32], "patch_overlap": 4,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 3,
       "start_filts": 8, "compute_dtype": "float32", "mesh_devices": 1,
       "transfer_dtype": "float32"}
MIN_AREA = {"sandeel": 2, "other": 4}
MERGE_GAP = {"sandeel": 3, "other": 0}


# ------------------------------------------------------------ functions
def _blobby(rng, h=60, w=200, n=25):
    """A probability map with blobs of different sizes and scores, NaN
    speckles and blobs touching the edges."""
    p = rng.rand(h, w).astype(np.float32) * 0.4
    for _ in range(n):
        y, x = rng.randint(0, h), rng.randint(0, w)
        dy, dx = rng.randint(1, 8), rng.randint(1, 12)
        p[max(y - dy, 0):y + dy, max(x - dx, 0):x + dx] = rng.uniform(0.5, 1)
    p[rng.rand(h, w) < 0.01] = np.nan
    return p


def _norm(dets):
    return sorted((tuple(int(v) for v in d["bounding_box"]), d["score"],
                   d["n_pixels"]) for d in dets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_matches_jax(seed):
    rng = np.random.RandomState(seed)
    p = _blobby(rng)
    for thr, area in ((0.5, 1), (0.7, 5)):
        assert _norm(P.detect_schools(p, thr, area)) == \
            _norm(J.detect_schools(p, thr, area))
        # streamed in chunks, with a connectivity cut at a file boundary
        dets = []
        for mod in (P, J):
            det = mod.StreamingDetector(thr, area)
            cuts = np.array([70, 150])
            for s in range(0, p.shape[1], 45):
                e = min(s + 45, p.shape[1])
                mod._stream_cut_chunk(det, p[:, s:e], s, e, cuts)
            dets.append(_norm(det.finalize()))
        assert dets[0] == dets[1] and len(dets[0]) > 3
        for gap in (0, 3, 8):
            raw = J.detect_schools(p, thr, area)
            assert _norm(P.merge_detections(raw, gap)) == \
                _norm(J.merge_detections(raw, gap))


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_and_ap_match_jax(seed):
    rng = np.random.RandomState(10 + seed)
    p = _blobby(rng)
    dets = J.detect_schools(p, 0.5, 1)
    gt = [list(d["bounding_box"]) for d in J.detect_schools(
        np.roll(p, (1, 2), (0, 1)), 0.6, 3)]
    a = np.asarray([d["bounding_box"] for d in dets])
    b = np.asarray(gt)
    np.testing.assert_array_equal(P.bbox_iou_matrix(a, b),
                                  J.bbox_iou_matrix(a, b))
    assert P.bbox_iou(gt[0], gt[1]) == J.bbox_iou(gt[0], gt[1])
    for thr in (0.1, 0.25, 0.5, 0.75):
        for got, want in zip(P.match_detections(dets, gt, thr),
                             J.match_detections(dets, gt, thr)):
            np.testing.assert_array_equal(got, want)
        scores, tp = J.match_detections(dets, gt, thr)
        assert P.average_precision(scores, tp, len(gt)) == \
            J.average_precision(scores, tp, len(gt))
    per_reader = [(dets, gt), (dets[:5], gt[:3]), ([], gt[:2])]
    assert repr(P.school_metrics(per_reader)) == \
        repr(J.school_metrics(per_reader))
    assert np.isnan(P.school_metrics([([], [])])["mean_ap"])


# --------------------------------------------------------------- surveys
@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("schools")
    out = {}
    for who in ("jax", "port", "cli"):
        make_survey_dir(root / f"memm_{who}", year=2017, n_echograms=1, H=H,
                        W=W, seed=SEED)
        out["memm_" + who] = root / f"memm_{who}"
        out["zarr_" + who] = make_zarr_survey(root / f"zarr_{who}",
                                              year=2017, n_echograms=2, H=H,
                                              W=W, seed=SEED)
    return out


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(21), jnp.zeros((1, 32, 32, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(21)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


def _readers(surveys, who, fmt):
    if fmt == "zarr":
        return [(DataReaderZarr if who != "jax" else JaxZarrReader)(
            surveys["zarr_" + who])]
    cls = JaxEchogram if who == "jax" else Echogram
    return [cls(d) for d in sorted(surveys["memm_" + who].iterdir())]


@pytest.fixture(scope="module")
def written(surveys, variables, tmp_path_factory):
    """The port's prediction stores of both surveys, one directory each."""
    _, v = variables
    runner = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v), CFG,
                           device="cpu")
    out = {}
    for fmt in ("memm", "zarr"):
        d = tmp_path_factory.mktemp(f"preds_{fmt}")
        for reader in _readers(surveys, "port", fmt):
            if fmt == "memm":
                save_reader_predictions_memm(
                    runner, reader, str(d / f"{reader.name}_pred.npy"),
                    PRELOAD)
            else:
                save_survey_predictions_zarr(
                    runner, reader, str(d / f"{reader.name}_pred.zarr"),
                    preload_n_pings=PRELOAD)
        out[fmt] = d
    return out


def _stored(path):
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    if str(path).endswith(".npy"):
        return np.load(path)
    return np.asarray(ZGroup.open(str(path))["annotation"][:]).transpose(
        0, 2, 1)


def _threshold(maps, start=0.5):
    """A threshold with no stored probability of any map within 2 float16
    ulp of it and some pixels above it in each channel."""
    vals = np.concatenate([m.ravel() for m in maps]).astype(np.float32)
    for thr in np.arange(start, 0.3, -0.0037):
        ulp = np.spacing(np.float16(thr)).astype(np.float32)
        near = np.abs(vals - np.float32(thr)) <= 2 * ulp
        if not near.any() and all((m[0] >= thr).sum() > 20
                                  and (m[1] >= thr).sum() > 20
                                  for m in maps):
            return float(thr)
    raise AssertionError("no clean threshold")


@pytest.mark.parametrize("fmt", ["memm", "zarr"])
def test_from_predictions_matches_jax(surveys, written, tmp_path, fmt):
    """The same written stores: metrics identical and both CSVs the JAX
    package's pandas text."""
    maps = [_stored(p) for p in sorted(written[fmt].iterdir())]
    thr = _threshold(maps)
    csvs = {}
    res = {}
    for who, mod in (("jax", J), ("port", P)):
        csvs[who] = (tmp_path / f"{who}_m.csv", tmp_path / f"{who}_d.csv")
        res[who] = mod.school_eval_survey(
            None, _readers(surveys, who, fmt), PRELOAD, prob_threshold=thr,
            min_area=MIN_AREA, merge_gap=MERGE_GAP,
            save_path_metrics=str(csvs[who][0]),
            save_path_detections=str(csvs[who][1]),
            from_predictions=str(written[fmt]))
    assert repr(res["port"]) == repr(res["jax"])
    assert res["port"]["categories"]["sandeel"]["n_detections"] > 0
    for got, want in zip(csvs["port"], csvs["jax"]):
        assert got.read_text() == want.read_text()
    if fmt == "zarr":    # datetime64 ping times, as pandas writes them
        assert csvs["port"][1].read_text().splitlines()[1].count(" ") >= 2


@pytest.mark.parametrize("fmt", ["memm", "zarr"])
def test_live_matches_jax(surveys, variables, written, fmt):
    """Live school eval through each package's predict path, and the
    port's live run against its own from-predictions run."""
    model, v = variables
    maps = [_stored(p) for p in sorted(written[fmt].iterdir())]
    thr = _threshold(maps)
    kw = dict(preload_n_pings=PRELOAD, prob_threshold=thr,
              min_area=MIN_AREA, merge_gap=MERGE_GAP)
    runner = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v), CFG,
                           device="cpu")
    got = P.school_eval_survey(runner, _readers(surveys, "port", fmt), **kw)
    want = J.school_eval_survey(JaxRunner(model, v, CFG),
                                _readers(surveys, "jax", fmt), **kw)
    stored = P.school_eval_survey(None, _readers(surveys, "port", fmt),
                                  from_predictions=str(written[fmt]), **kw)
    assert repr(got) == repr(stored)
    assert runner.forwards > 0
    for name in ("sandeel", "other"):
        g, w = got["categories"][name], want["categories"][name]
        assert g["n_detections"] == w["n_detections"] > 0
        assert g["n_gt"] == w["n_gt"] > 0
        assert g["ap"] == w["ap"] and g["recall"] == w["recall"]
    # boxes and pixel counts equal, scores within 2e-3
    dets = {}
    for who, mod, r in (("port", P, runner),
                        ("jax", J, JaxRunner(model, v, CFG))):
        reader = _readers(surveys, who, fmt)[0]
        dets[who] = mod.detect_reader_schools(r, reader, PRELOAD, thr, 1)
    for ch in (0, 1):
        a, b = _norm(dets["port"][ch]), _norm(dets["jax"][ch])
        assert [(x[0], x[2]) for x in a] == [(x[0], x[2]) for x in b]
        assert np.allclose([x[1] for x in a], [x[1] for x in b], atol=2e-3)


def test_cli_from_predictions_builds_no_runner(surveys, written, tmp_path,
                                               monkeypatch):
    """school_from_predictions: the CLI loads no checkpoint, builds no
    runner and touches no device (no --device, no card), and writes the
    JAX CLI's two CSVs."""
    import yaml
    from crimac_unet_tpu.pipeline.school_eval import main as jax_main
    from crimac_unet_tpu_torch.pipeline import runner as runner_mod

    ckpt = tmp_path / "run0" / "model.pt"
    ckpt.parent.mkdir()
    ckpt.write_bytes(b"never opened")
    cfg = dict(CFG, data_mode="memm", partition_predict="selected surveys",
               evaluation_surveys=[2017], random_seed=3,
               preload_n_pings=PRELOAD,
               school_from_predictions=str(written["memm"]),
               school_prob_threshold=_threshold(
                   [_stored(p) for p in written["memm"].iterdir()]))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "setpyenv.json").write_text(
        '{"path_to_echograms": "%s"}' % surveys["memm_cli"])
    monkeypatch.setenv("CRIMAC_SETPYENV", str(tmp_path / "setpyenv.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_runner(*args, **kwargs):
        raise AssertionError("a runner was built")
    monkeypatch.setattr(runner_mod, "GriddedRunner", no_runner)
    args = ["--yaml_path", str(tmp_path / "cfg.yaml"), "--checkpoint_path",
            str(ckpt)]
    P.main(args + ["--save_path_metrics", str(tmp_path / "port"),
                   "--save_path_plot", str(tmp_path / "plots")])
    jax_main(args + ["--save_path_metrics", str(tmp_path / "jax"),
                     "--save_path_plot", str(tmp_path / "plots")])
    for name in ("2017_school_eval.csv", "2017_schools.csv"):
        got = tmp_path / "port" / "cfg" / "run0" / name
        want = tmp_path / "jax" / "cfg" / "run0" / name
        assert got.read_text() == want.read_text()
    assert not (tmp_path / "plots").exists()


def test_cli_live_on_cpu(surveys, variables, tmp_path, monkeypatch):
    """The live CLI on the CPU (--device cpu) with a reference .pt."""
    import yaml
    _, v = variables
    ckpt = tmp_path / "run0" / "model.pt"
    ckpt.parent.mkdir()
    save_torch_checkpoint(v, ckpt)
    cfg = dict(CFG, data_mode="memm", partition_predict="selected surveys",
               evaluation_surveys=[2017], random_seed=3,
               preload_n_pings=PRELOAD)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "setpyenv.json").write_text(
        '{"path_to_echograms": "%s"}' % surveys["memm_cli"])
    monkeypatch.setenv("CRIMAC_SETPYENV", str(tmp_path / "setpyenv.json"))
    P.main(["--yaml_path", str(tmp_path / "cfg.yaml"), "--checkpoint_path",
            str(ckpt), "--save_path_metrics", str(tmp_path / "m"),
            "--save_path_plot", str(tmp_path / "p"), "--device", "cpu"])
    text = (tmp_path / "m" / "cfg" / "run0" / "2017_school_eval.csv"
            ).read_text().splitlines()
    assert text[0] == ",".join(P.SCHOOL_METRICS_COLUMNS)
    assert len(text) == 1 + 2 * (len(P.DEFAULT_IOU_THRESHOLDS) + 1) + 1
    assert os.path.isfile(tmp_path / "m" / "cfg" / "run0" / "2017_schools.csv")
