"""The port's trained-weight and survey-scale checks (``scripts/torch_*.py``)
against the JAX package.

The JAX package's production defaults (``config_serving.yaml``: uint8
transfer and output, slab mode, overlap 20) rest on six scripts that ran
it with trained weights or at survey scale.  The port's counterparts
run here at a small size (depth 3, start_filts 8, patch 64, float32
compute) on the CPU, where the kernels take their plain versions.  The
weights act like trained ones: seeded weights whose classifier is scaled
by 3, so the probabilities sit near 0 and 1 (without underflowing
float16).  The same weights go to the JAX package through
``torch_to_flax_variables``, and each script's modes run through the
JAX package's functions directly, as ``scripts/u8_bound.py:60-125`` and
``scripts/eval_u8_bound.py:55-73`` run them (this file imports neither
script).

Tolerances: write masks (the written zero set) and evaluation counts
identical; probabilities within 2 float16 ulp (float32 convolutions
summed in another order; uint8 outputs within one code); every |dF1|
and every output-uint8 law reading within 1e-4 of the JAX package's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.data.zarrlite import ZGroup
from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
from crimac_unet_tpu_torch.models.weights import torch_to_flax_variables
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.pipeline import school_eval
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.predict import \
    save_survey_predictions_zarr
from scripts import (torch_check_common as common, torch_eval_u8_bound,
                     torch_school_ap_trained, torch_school_eval_soak,
                     torch_serving_geometry_ab, torch_soak50k, torch_u8_bound)

# overlap 10 at depth 3 (alignment 4): a misaligned slab grid, as the
# flagship's overlap 20 at depth 5
MODEL = {"depth": 3, "start_filts": 8, "patch_size": [64, 64],
         "patch_overlap": 10, "compute_dtype": "float32", "fwd_batch": 8}
PRELOAD = 150        # W = 400 -> three chunks, the last one narrower
CLASSIFIER_SCALE = 3.0
TOL = 1e-4


def _f16_close(p, q):
    """Within 2 float16 ulp of the larger magnitude."""
    tol = 2 * np.spacing(np.maximum(np.abs(p), np.abs(q)).astype(
        np.float16)).astype(np.float32)
    return np.abs(p - q) <= tol


@pytest.fixture(scope="module")
def weights():
    """(port state dict, JAX model, JAX variables)."""
    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    cfg = common.model_config(MODEL)
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(7)
                      ).state_dict()
    for k in ("conv_final.weight", "conv_final.bias"):
        sd[k] = sd[k] * CLASSIFIER_SCALE
    return sd, jax_build_unet(cfg), torch_to_flax_variables(sd)


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """The same seeded zarr survey written by each package."""
    from crimac_unet_tpu.data import fixtures as jfix
    root = tmp_path_factory.mktemp("trained_checks")
    kw = dict(year=2017, n_echograms=1, H=100, W=400, seed=3, n_schools=6)
    return {"port": make_zarr_survey(root / "port", **kw),
            "jax": jfix.make_zarr_survey(root / "jax", **kw), "root": root}


def _jax_predict(model, v, reader, cfg):
    from crimac_unet_tpu.pipeline.inference import GriddedRunner, \
        predict_reader
    chunks = {s: np.asarray(p, np.float32) for s, _, p, _ in
              predict_reader(GriddedRunner(model, v, cfg), reader, PRELOAD)}
    return np.concatenate([chunks[s] for s in sorted(chunks)], axis=2)


def _sklearn_f1(scores, y):
    """The JAX scripts' f1_of: sklearn's PR curve and the reference's F1."""
    from sklearn.metrics import precision_recall_curve
    prec, rec, _ = precision_recall_curve(y, scores)
    denom = prec + rec
    f1 = np.divide(2 * prec * rec, denom, out=np.zeros_like(denom),
                   where=denom != 0)
    return float(f1.max())


def _jax_u8_readings(outp, lab):
    """scripts/u8_bound.py:60-125 on the JAX package's outputs."""
    base = outp["exact_f32"]
    written = base != 0
    wmask = written[0]
    y = lab[:wmask.shape[0], :wmask.shape[1]][wmask] == 27

    def f1_of(arr):
        return _sklearn_f1(arr[0][wmask], y)
    res = {"f1_exact_f32": f1_of(base)}
    for name in ("patch_u8", "serving_u8", "serving_out_u8"):
        arr = outp[name]
        diff = np.abs(base - arr)[written]
        res[name] = {"masks_equal": bool(((base == 0) == (arr == 0)).all()),
                     "mean_abs_dprob": float(diff.mean()),
                     "p99_abs_dprob": float(np.percentile(diff, 99)),
                     "max_abs_dprob": float(diff.max()),
                     "f1": f1_of(arr),
                     "abs_dF1": abs(f1_of(arr) - res["f1_exact_f32"])}
    a, b = outp["serving_u8"], outp["serving_out_u8"]
    extra_zero = (b == 0) & (a != 0)
    res["output_u8_isolated"] = {
        "max_abs_dprob": float(np.abs(a - b).max()),
        "n_extra_zero": int(extra_zero.sum()),
        "max_p_at_extra_zero": float(a[extra_zero].max())
        if extra_zero.any() else 0.0,
        "abs_dF1_vs_serving_u8": abs(f1_of(b) - f1_of(a))}
    return res


@pytest.fixture(scope="module")
def u8(weights, surveys):
    """Each package's four prediction modes and readings."""
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
    sd, model, v = weights
    port_out = {}
    port = torch_u8_bound.run(sd, surveys["port"], "cpu", MODEL,
                              preload_n_pings=PRELOAD, outputs=port_out)
    jreader = JaxReader(surveys["jax"])
    jax_out = {name: _jax_predict(model, v, jreader,
                                  common.model_config(MODEL, **over))
               for name, over in torch_u8_bound.MODES.items()}
    n_range, n_pings = jax_out["exact_f32"].shape[1:]
    lab = np.nan_to_num(jreader.get_label_slice(0, n_pings, 0, n_range).T,
                        nan=0)
    return port, port_out, _jax_u8_readings(jax_out, lab), jax_out


@pytest.mark.parametrize("mode", list(torch_u8_bound.MODES))
def test_u8_mode_matches_jax(u8, mode):
    _, port_out, _, jax_out = u8
    p, q = port_out[mode], jax_out[mode]
    assert p.shape == q.shape and (q != 0).any()
    np.testing.assert_array_equal(p == 0, q == 0, err_msg=mode)
    if mode == "serving_out_u8":     # uint8 codes: within one code
        assert np.abs(p - q).max() <= 1 / 255 + 2 ** -11, mode
    else:
        assert _f16_close(p, q).all(), (mode, np.abs(p - q).max())


@pytest.mark.parametrize("group", ["patch_u8", "serving_u8",
                                   "serving_out_u8", "output_u8_isolated"])
def test_u8_readings_match_jax(u8, group):
    port, _, jax, _ = u8
    assert abs(port["f1_exact_f32"] - jax["f1_exact_f32"]) <= TOL
    got, want = port[group], jax[group]
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, (bool, int)) and key != "max_abs_dprob":
            assert got[key] == w, (group, key, got[key], w)
        elif "dF1" in key or group == "output_u8_isolated":
            assert abs(got[key] - w) <= TOL, (group, key, got[key], w)
    # the trained-weight laws the card holds (chip_smoke.py phase 19)
    if group in ("patch_u8", "serving_u8"):
        assert got["masks_equal"]
    if group == "output_u8_isolated":
        assert got["max_abs_dprob"] <= 1 / 510 + 2 ** -12
        assert got["max_p_at_extra_zero"] <= float(np.float16(1 / 510))


def test_u8_launches_counted_per_mode(u8):
    """One entry per mode, its forwards counted; on the CPU no kernel
    launches (the plain versions run)."""
    port = u8[0]
    assert set(port["launches"]) == {f"u8_{m}" for m in torch_u8_bound.MODES}
    for name, c in port["launches"].items():
        assert c["forwards"] > 0 and c["gather_db"] == 0, (name, c)


@pytest.fixture(scope="module")
def evals(weights, surveys):
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
    from crimac_unet_tpu.ops import metrics as jax_metrics
    from crimac_unet_tpu.pipeline.inference import (GriddedRunner,
                                                    evaluate_reader as jev)
    sd, model, v = weights
    port = torch_eval_u8_bound.run(sd, surveys["port"], "cpu", MODEL)
    jreader = JaxReader(surveys["jax"])
    jax = {}
    for td in torch_eval_u8_bound.TRANSFERS:
        h = np.asarray(jev(GriddedRunner(model, v, common.model_config(
            MODEL, transfer_dtype=td)), jreader, jax_metrics.new_histogram()))
        f1, _ = jax_metrics.max_f1(jax_metrics.pr_curve_from_histogram(h))
        jax[td] = {"max_f1": float(f1), "n_scored": int(h.sum()),
                   "n_pos": int(h[0].sum())}
    for td in ("bfloat16", "uint8"):     # scripts/eval_u8_bound.py:72-75
        assert jax[td]["n_scored"] == jax["float32"]["n_scored"]
        assert jax[td]["n_pos"] == jax["float32"]["n_pos"]
        jax[td]["dF1_vs_float32"] = (jax[td]["max_f1"]
                                     - jax["float32"]["max_f1"])
    return port, jax


@pytest.mark.parametrize("td", torch_eval_u8_bound.TRANSFERS)
def test_eval_transfer_matches_jax(evals, td):
    port, jax = evals
    assert port[td]["n_scored"] == jax[td]["n_scored"] > 0
    assert port[td]["n_pos"] == jax[td]["n_pos"] > 0
    assert abs(port[td]["max_f1"] - jax[td]["max_f1"]) <= TOL
    if td != "float32":
        assert abs(port[td]["dF1_vs_float32"]
                   - jax[td]["dF1_vs_float32"]) <= TOL
    assert port["launches"][f"eval_{td}"]["forwards"] > 0


def test_eval_run_refuses_changed_counts(weights, surveys, monkeypatch):
    """A transfer that changed which pixels are scored fails the run."""
    from crimac_unet_tpu_torch.pipeline import eval_gridded
    sd = weights[0]
    orig = eval_gridded.evaluate_reader

    def drop_one(runner, reader, hist, *a, **kw):
        h = np.asarray(orig(runner, reader, hist, *a, **kw)).copy()
        if runner.transfer_dtype == "uint8":
            h[1, np.nonzero(h[1])[0][0]] -= 1
        return h
    monkeypatch.setattr(eval_gridded, "evaluate_reader", drop_one)
    with pytest.raises(RuntimeError, match="uint8 transfer changed"):
        torch_eval_u8_bound.run(sd, surveys["port"], "cpu", MODEL)


F1_CASES = {
    "ties": lambda r: (np.round(r.rand(5000) * 64) / 64, r.rand(5000) < 0.3),
    "saturated": lambda r: (np.where(r.rand(4000) < 0.5, r.rand(4000) * 1e-3,
                                     1 - r.rand(4000) * 1e-3),
                            r.rand(4000) < 0.5),
    "u8_codes": lambda r: (np.round(r.rand(3000) * 255) / 255,
                           r.rand(3000) < 0.1),
    "few_positives": lambda r: (r.rand(2000), np.arange(2000) < 3),
}


@pytest.mark.parametrize("case", list(F1_CASES))
def test_f1_path_equals_sklearn(case):
    """The scripts' max-F1 through the port's PR histogram is sklearn's
    ``precision_recall_curve`` max F1 on float16 scores."""
    scores, y = F1_CASES[case](np.random.RandomState(len(case)))
    scores = scores.astype(np.float16).astype(np.float32)
    assert common.max_f1(scores, y) == pytest.approx(
        _sklearn_f1(scores, y), abs=1e-12)


def test_f1_path_equals_sklearn_on_mode_outputs(u8, surveys):
    _, port_out, _, _ = u8
    reader = DataReaderZarr(surveys["port"])
    base = port_out["exact_f32"]
    wmask = base[0] != 0
    lab = common.raw_labels(reader, *base.shape[1:])
    y = lab[wmask] == 27
    for name, arr in port_out.items():
        assert common.max_f1(arr[0][wmask], y) == pytest.approx(
            _sklearn_f1(arr[0][wmask], y), abs=1e-12), name


def test_big_val_fixture_matches_jax(tmp_path):
    """The big held-out fixture, bit for bit, at 2 of its 14 echograms
    (one seeded stream writes them in order): every file of each
    echogram directory, the pickled objects included."""
    from crimac_unet_tpu.data.fixtures import make_survey_dir as jax_make
    port = Path(torch_school_ap_trained.ensure_big_val_fixture(
        tmp_path, n_echograms=2))
    jax_make(tmp_path / "jax", year=2016, n_echograms=2, H=700, W=400,
             seed=77, n_schools=12)
    names = sorted(p.name for p in port.iterdir() if p.is_dir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2
    for name in names:
        files = sorted(f.name for f in (port / name).iterdir())
        assert files == sorted(f.name for f in (tmp_path / "jax" / name
                                                ).iterdir())
        for f in files:
            assert (port / name / f).read_bytes() == (
                tmp_path / "jax" / name / f).read_bytes(), (name, f)


def test_big_val_ground_truth_matches_jax(tmp_path):
    """Ground-truth schools per category on the whole 14-echogram fixture:
    the port's, the JAX package's and ``BIG_VAL_GT`` agree."""
    from crimac_unet_tpu.data.fixtures import make_survey_dir as jax_make
    from crimac_unet_tpu.data.memmap_reader import \
        get_echograms as jax_get_echograms
    from crimac_unet_tpu.pipeline import school_eval as jax_school_eval
    port = torch_school_ap_trained.ensure_big_val_fixture(tmp_path)
    jax_make(tmp_path / "jax", year=2016, n_echograms=14, H=700, W=400,
             seed=77, n_schools=12)
    counts = {}
    for who, ge, se, root in (
            ("port", get_echograms, school_eval, port),
            ("jax", jax_get_echograms, jax_school_eval, tmp_path / "jax")):
        readers = ge(years=[2016], path_to_echograms=str(root),
                     minimum_shape=50)
        assert len(readers) == 14
        cats = se.CATEGORY_CHANNELS
        n = {name: 0 for name in cats}
        for r in readers:
            boxes = se.gt_boxes_by_category(r, [c for c, _ in cats.values()])
            for name, (raw, _) in cats.items():
                n[name] += len(boxes[raw])
        counts[who] = n
    assert counts["port"] == counts["jax"] == \
        torch_school_ap_trained.BIG_VAL_GT


def test_school_ap_run_matches_jax(weights, tmp_path):
    """``run()`` on 2 echograms of the big fixture against the JAX
    package's ``school_eval_survey`` with the same weights."""
    from crimac_unet_tpu.data.memmap_reader import \
        get_echograms as jax_get_echograms
    from crimac_unet_tpu.pipeline.inference import GriddedRunner
    from crimac_unet_tpu.pipeline.school_eval import \
        school_eval_survey as jax_school_eval_survey
    sd, model, v = weights
    val = torch_school_ap_trained.ensure_big_val_fixture(tmp_path,
                                                         n_echograms=2)
    port = torch_school_ap_trained.run(sd, val, "cpu", MODEL,
                                       save_dir=str(tmp_path))
    jax = jax_school_eval_survey(
        GriddedRunner(model, v, common.model_config(MODEL)),
        jax_get_echograms(years=[2016], path_to_echograms=val,
                          minimum_shape=50),
        preload_n_pings=1000, prob_threshold=0.5)
    assert port["n_echograms"] == 2
    assert (tmp_path / "2016_school_eval.csv").is_file()
    assert (tmp_path / "2016_schools.csv").is_file()
    assert port["launches"]["school_ap"]["forwards"] > 0
    for name, want in jax["categories"].items():
        got = port["categories"][name]
        assert got["n_gt"] == want["n_gt"] > 0, name
        assert got["n_detections"] == want["n_detections"], name
        np.testing.assert_allclose(got["ap"], want["ap"], atol=2e-3)
    assert port["mean_ap"] == pytest.approx(jax["mean_ap"], abs=2e-3)


def test_streaming_detector_matches_jax():
    """The port's detector over the seeded soak stream gives the JAX
    detector's detections at 5 000 pings."""
    from crimac_unet_tpu.pipeline.school_eval import StreamingDetector
    n = 5000
    rng = np.random.RandomState(0)
    det = StreamingDetector(0.5, min_area=2)
    for x0 in range(0, n, torch_school_eval_soak.CHUNK):
        det.add_chunk(torch_school_eval_soak.chunk_probs(
            rng, min(torch_school_eval_soak.CHUNK, n - x0)), x0)
    want = det.finalize()
    got = torch_school_eval_soak.stream(n)
    assert len(want) > 1000 and got == want


def test_school_eval_soak_run_reports():
    res = torch_school_eval_soak.run(2000, check_pings=2000)
    assert res["dense_equal"] and res["detections"] > 0
    assert res["n_pings"] == 2000 and res["pings_per_sec"] > 0
    assert isinstance(res["rss_delta_bytes"], int)


@pytest.fixture(scope="module")
def soak_survey(tmp_path_factory):
    """A 2 500-ping x 100-range soak survey, built by the script's child
    process."""
    work = tmp_path_factory.mktemp("soak")
    sv = torch_soak50k.ensure_fixture(work, 2500, 100)
    assert (work / "soak_2500x100" / "S2017843.ok").is_file()
    return work, sv


SOAK_KEYS = {"mode", "transfer_dtype", "static_grid", "n_pings", "n_range",
             "codec_backend", "survey_compressor", "peak_device_bytes",
             "wall_s", "pings_per_sec", "rss_before_bytes", "rss_peak_bytes",
             "rss_delta_bytes", "rss_peak_s", "rss_after_scan_bytes",
             "timers", "launches", "device", "chunks", "forward_shapes"}
STORE_KEYS = {"store_shape", "store_pings", "ping_time_equal",
              "store_finite", "written_px", "pings_with_output",
              "store_compressor"}


@pytest.mark.parametrize("mode", ["patch", "slab"])
def test_soak_store_matches_save_survey_predictions_zarr(weights,
                                                         soak_survey, mode):
    sd = weights[0]
    work, sv = soak_survey
    res = torch_soak50k.run(mode, sd, sv, "cpu", MODEL,
                            out=work / f"soak_{mode}.zarr")
    assert set(res) == SOAK_KEYS | STORE_KEYS
    assert res["store_pings"] == res["n_pings"] == 2500
    assert res["ping_time_equal"] and res["store_finite"]
    assert res["written_px"] > 0 and res["peak_device_bytes"] is None
    assert res["launches"]["forwards"] > 0 and res["timers"]
    cfg = common.model_config(MODEL, infer_mode=mode,
                              transfer_dtype="bfloat16")
    runner = common.make_runner(sd, cfg, "cpu")
    save_survey_predictions_zarr(runner, DataReaderZarr(sv),
                                 str(work / f"direct_{mode}.zarr"))
    got = ZGroup.open(str(work / f"soak_{mode}.zarr"))
    want = ZGroup.open(str(work / f"direct_{mode}.zarr"))
    for key in ("annotation", "ping_time", "range", "category"):
        np.testing.assert_array_equal(got[key][:], want[key][:], key)


def test_soak_eval_matches_evaluate_reader(weights, soak_survey):
    sd = weights[0]
    _, sv = soak_survey
    res = torch_soak50k.run("eval", sd, sv, "cpu", MODEL)
    assert set(res) == SOAK_KEYS | {"n_scored", "n_pos"}
    assert res["transfer_dtype"] == "uint8"
    runner = common.make_runner(sd, common.model_config(
        MODEL, transfer_dtype="uint8"), "cpu")
    h = np.asarray(evaluate_reader(runner, DataReaderZarr(sv),
                                   metrics.new_histogram()))
    assert (res["n_scored"], res["n_pos"]) == (int(h.sum()),
                                               int(h[0].sum()))
    assert res["n_scored"] > 0


def test_geometry_warns_only_on_the_misaligned_arm(weights, surveys):
    sd = weights[0]
    res = torch_serving_geometry_ab.run(sd, surveys["port"], "cpu", MODEL,
                                        passes=1, overlaps=(10, 8),
                                        preload_n_pings=PRELOAD)
    assert res["ov10"]["warned"] and not res["ov10"]["aligned"]
    assert not res["ov8"]["warned"] and res["ov8"]["aligned"]
    for tag in ("ov10", "ov8"):
        r = res[tag]
        assert r["stride"] == 64 - 2 * int(tag[2:])
        assert 0 < r["f1_oracle"] <= 1 and r["pings_per_sec"] > 0
        assert 0 <= r["slab_vs_patch_u8"]["frac_gt_2codes"] <= 1
        # one runner for the first pass and the timed one: one slab
        # forward for each of the three chunks a pass
        assert res["launches"][f"geom_{tag}_serving"]["forwards"] == 2 * 3
        assert len(r["pass_walls_s"]) == 1


@pytest.mark.parametrize("script", ["u8", "eval", "geometry", "school_ap",
                                    "soak"])
def test_scripts_raise_without_a_card(script, weights, monkeypatch,
                                      tmp_path):
    """``--device`` defaults to cuda, which raises without a card; it
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = weights[0]
    call = {"u8": lambda: torch_u8_bound.run(sd, "unused"),
            "eval": lambda: torch_eval_u8_bound.run(sd, "unused"),
            "geometry": lambda: torch_serving_geometry_ab.run(sd, "unused"),
            "school_ap": lambda: torch_school_ap_trained.run(sd, tmp_path),
            "soak": lambda: torch_soak50k.run("patch", sd, "unused")}[script]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not any(tmp_path.iterdir())


def test_seabed_scan_memory_flat_in_survey_length(tmp_path, monkeypatch):
    """The seabed scan runs inside a survey's first streaming call: its
    host memory must not grow with the survey.  Over three read blocks
    its traced peak stays that of one (it held the previous block and a
    NaN-scrubbed copy beside each new read, so a 20 000-ping soak's RSS
    delta was 2.4x the 4000-ping run's on the card)."""
    import tracemalloc

    from crimac_unet_tpu_torch.data import zarr_reader
    monkeypatch.setattr(zarr_reader, "_SEABED_READ_ELEMS", 100 * 1024)
    peaks = {}
    for w in (1000, 3000):       # one read block, three
        r = DataReaderZarr(make_zarr_survey(tmp_path / str(w), n_echograms=1,
                                            H=100, W=w, seed=2))
        tracemalloc.start()
        try:
            r.get_seabed(0, None)
            peaks[w] = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert len(r.get_seabed(0, None)) == w
    block = 100 * 1024 * 4
    assert peaks[3000] <= peaks[1000] + block // 4, peaks


def test_output_u8_deviation_law():
    """How far a uint8 output may sit from the float16 output of the same
    probability: the code rounds p by at most 1/510, and both the float16
    output and the code's float16 dequant round by half a float16 ulp
    (2^-12 in [0.5, 1)), so the law is 1/510 + 2^-11.  Phase 19's bound
    ``U8_OUT_MAX`` = 1/510 + 2^-12 counts one of the two roundings: the
    15 000-step recipe checkpoint read 2^-12 * 10 on the card, above it
    (ROADMAP C F15).  The port's quantization is the JAX package's."""
    import jax.numpy as jnp

    from crimac_unet_tpu.pipeline import infer_common as jax_ic
    from crimac_unet_tpu_torch.pipeline import infer_common as ic
    p = np.concatenate([np.linspace(0, 1, 2 ** 20 + 1, dtype=np.float32),
                        np.float32(0.5) + np.float32(2 ** -12) * (
                            np.arange(-4, 5, dtype=np.float32) + 0.5) / 255])
    p = np.clip(p, 0, 1)
    codes = ic._quantize_prob_u8(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(jax_ic._quantize_prob_u8(jnp.asarray(p))))
    np.testing.assert_array_equal(ic._U8_PROB_DEQUANT,
                                  jax_ic._U8_PROB_DEQUANT)
    d = np.abs(p.astype(np.float16).astype(np.float32)
               - ic._U8_PROB_DEQUANT[codes].astype(np.float32))
    assert d.max() <= 1 / 510 + 2 ** -11
    assert d.max() > 1 / 510 + 2 ** -12      # the card's 15 000-step reading
    # and the zero set: a code 0 only where p < 1/510 (half to even at it)
    assert p[codes == 0].max() <= np.float32(1 / 510)
