"""The port's A/B benches and recipe studies (``scripts/torch_*.py``)
against the JAX package and the JAX repo's scripts.

Each tool runs here at a small size (depth 3, start_filts 8, patch 64,
overlap 10, float32 compute; the static grid at depth 2) on the CPU,
where the kernels take their plain versions.  The weights are seeded,
the classifier scaled by 3 so probabilities sit near 0 and 1, and go to
the JAX package through ``torch_to_flax_variables``.  The JAX side runs
the JAX package's functions as the JAX scripts call them; the recipe
configurations are held to the JAX scripts' own functions
(``scripts/fast_recipe.py``, ``scripts/r3_tpu_session.py``,
``scripts/meta_recipe.py``, imported here only).

Tolerances, each stated where it is used:
- evaluation: per-dtype scored and positive pixel counts identical, max
  F1 within 2e-3 (the repo's evaluation bound);
- school detection: at a threshold on which both packages' probability
  maps put every pixel on the same side, boxes and pixel counts identical
  and scores within 2e-3 (``tests/test_torch_school_eval.py``'s rule);
- the post-processing sweep from the same stores: rows bit-equal, the
  same chosen point;
- pooled metadata: the host and pooled arms' first losses within 1e-5
  relative (``tests/test_torch_meta_train.py``'s loss bound);
- configurations: equal but for the port's documented keys ``device``
  and ``use_device_pool``;
- static grid: the (R, C) sets equal the JAX runner's on the same
  fixture, the arms' outputs bit-identical (as JAX's are on the CPU).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
from crimac_unet_tpu_torch.models.weights import torch_to_flax_variables
from scripts import (torch_check_common as common, torch_eval_quant_bench,
                     torch_fast_recipe, torch_meta_recipe,
                     torch_pooled_meta_bench, torch_r3_session,
                     torch_school_ap_trained, torch_school_postproc_sweep,
                     torch_school_serving_bench, torch_static_grid)

REPO = Path(__file__).resolve().parent.parent
# overlap 10 at depth 3 (alignment 4): a misaligned slab grid, as the
# flagship's overlap 20 at depth 5
MODEL = {"depth": 3, "start_filts": 8, "patch_size": [64, 64],
         "patch_overlap": 10, "compute_dtype": "float32", "fwd_batch": 8}
PRELOAD = 150        # W = 400 -> three chunks, the last one narrower
CLASSIFIER_SCALE = 3.0
EVAL_F1_TOL = 2e-3
SCORE_TOL = 2e-3
LOSS_RTOL = 1e-5
PORT_ONLY_KEYS = {"device", "use_device_pool"}


def _jax_scripts(*names):
    """The JAX repo's scripts as modules (they import each other by bare
    name from ``scripts/``)."""
    path = str(REPO / "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    return [importlib.import_module(n) for n in names]


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
    root = tmp_path_factory.mktemp("ab_benches")
    kw = dict(year=2017, n_echograms=1, H=100, W=400, seed=3, n_schools=6)
    return {"port": make_zarr_survey(root / "port", **kw),
            "jax": jfix.make_zarr_survey(root / "jax", **kw)}


def _jax_runner(weights, **over):
    import warnings

    from crimac_unet_tpu.pipeline.inference import GriddedRunner
    _, model, v = weights
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GriddedRunner(model, v, common.model_config(MODEL, **over))


# ------------------------------------------------ item 1: eval by dtype
@pytest.fixture(scope="module")
def evals(weights, surveys):
    """The port's run and the JAX package's ``evaluate_reader`` at each
    transfer dtype (scripts/eval_quant_bench.py:44-56)."""
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
    from crimac_unet_tpu.ops import metrics as jm
    from crimac_unet_tpu.pipeline.inference import evaluate_reader as jev
    port = torch_eval_quant_bench.run(weights[0], surveys["port"], "cpu",
                                      MODEL, passes=1, log=lambda m: None)
    jreader = JaxReader(surveys["jax"])
    jax = {}
    for td in torch_eval_quant_bench.TRANSFERS:
        h = np.asarray(jev(_jax_runner(weights, transfer_dtype=td), jreader,
                           jm.new_histogram()))
        jax[td] = {"f1": float(jm.max_f1(jm.pr_curve_from_histogram(h))[0]),
                   "n_scored": int(h.sum()), "n_pos": int(h[0].sum())}
    return port, jax


@pytest.mark.parametrize("td", torch_eval_quant_bench.TRANSFERS)
def test_eval_quant_matches_jax(evals, td):
    port, jax = evals
    p = port["transfers"][td]
    assert p["n_scored"] == jax[td]["n_scored"] > 0
    assert p["n_pos"] == jax[td]["n_pos"] > 0
    assert abs(p["f1"] - jax[td]["f1"]) <= EVAL_F1_TOL
    assert abs(p["abs_dF1_vs_float32"]
               - abs(jax[td]["f1"] - jax["float32"]["f1"])) <= EVAL_F1_TOL
    assert port["eval_pings_per_sec"][td] > 0
    # the warm pass and one timed pass, every sub-batch counted
    assert port["launches"][f"evalq_{td}"]["forwards"] > 0


def test_eval_quant_run_refuses_changed_counts(weights, surveys,
                                               monkeypatch):
    """A transfer that changed which pixels are scored fails the run."""
    from crimac_unet_tpu_torch.pipeline import eval_gridded
    orig = eval_gridded.evaluate_reader

    def drop_one(runner, reader, hist, *a, **kw):
        h = np.asarray(orig(runner, reader, hist, *a, **kw)).copy()
        if runner.transfer_dtype == "bfloat16":
            h[0, np.nonzero(h[0])[0][0]] -= 1
        return h
    monkeypatch.setattr(eval_gridded, "evaluate_reader", drop_one)
    with pytest.raises(RuntimeError, match="bfloat16 transfer changed"):
        torch_eval_quant_bench.run(weights[0], surveys["port"], "cpu", MODEL,
                                   passes=1, log=lambda m: None)


# ------------------------------------- item 2: live school detection
def _agreeing_threshold(pairs, start=0.6):
    """A threshold on which each (port, JAX) pair of probability maps
    puts every pixel on the same side, with pixels above it in both
    channels (seeded weights give flat maps, so no threshold is far from
    every probability; the pairs differ within 2 float16 ulp)."""
    for thr in np.arange(start, 0.2, -0.0037):
        if all(np.array_equal(p >= thr, q >= thr)
               and (p[0] >= thr).sum() > 20 and (p[1] >= thr).sum() > 20
               for p, q in pairs):
            return float(thr)
    raise AssertionError("no agreeing threshold")


def _norm(dets):
    return sorted((tuple(int(v) for v in d["bounding_box"]),
                   float(d["score"]), int(d["n_pixels"])) for d in dets)


@pytest.fixture(scope="module")
def detections(weights, surveys):
    """Both arms through the port's run and the JAX package's
    ``detect_reader_schools`` at one threshold both packages' maps agree
    on."""
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
    from crimac_unet_tpu.pipeline.inference import predict_reader as jpredict
    from crimac_unet_tpu.pipeline.school_eval import \
        detect_reader_schools as jdetect
    sd = weights[0]
    reader = common.zarr_reader(surveys["port"])
    jreader = JaxReader(surveys["jax"])
    pairs = []
    for over in torch_school_serving_bench.ARMS.values():
        port_map = common.predict_survey(common.make_runner(
            sd, common.model_config(MODEL, **over), "cpu"), reader,
            PRELOAD)[0]
        chunks = {st: np.asarray(p, np.float32) for st, _, p, _ in
                  jpredict(_jax_runner(weights, **over), jreader, PRELOAD)}
        pairs.append((port_map, np.concatenate(
            [chunks[st] for st in sorted(chunks)], axis=2)))
    thr = _agreeing_threshold(pairs)
    outputs = {}
    port = torch_school_serving_bench.run(
        sd, surveys["port"], "cpu", MODEL, passes=1, preload_n_pings=PRELOAD,
        prob_threshold=thr, outputs=outputs, log=lambda m: None)
    jax = {tag: jdetect(_jax_runner(weights, **over), jreader, PRELOAD, thr)
           for tag, over in torch_school_serving_bench.ARMS.items()}
    return port, outputs, jax


@pytest.mark.parametrize("arm", list(torch_school_serving_bench.ARMS))
def test_school_serving_matches_jax(detections, arm):
    port, outputs, jax = detections
    assert port[arm]["store_equal"]
    for ch in (0, 1):
        a, b = _norm(outputs[arm][ch]), _norm(jax[arm][ch])
        assert len(a) == len(b) > 0
        assert [(x[0], x[2]) for x in a] == [(x[0], x[2]) for x in b]
        assert np.allclose([x[1] for x in a], [x[1] for x in b],
                           atol=SCORE_TOL)
    n = port[arm]["n_detections"]
    assert n == {"sandeel": len(jax[arm][0]), "other": len(jax[arm][1])}
    name = "detect_" + arm.split("+")[0]
    assert port["launches"][name]["forwards"] > 0
    assert port["launches"][name + "_store"]["forwards"] > 0


@pytest.mark.parametrize("arm", list(torch_school_serving_bench.ARMS))
def test_school_serving_detector_share(detections, arm):
    """Each live call is paired with a prediction pass alone of the same
    runner in the same process; the detector's share is the live wall
    less the best prediction wall, over the live wall."""
    r = detections[0][arm]
    assert len(r["predict_walls_s"]) == len(r["walls_s"]) == 1
    assert r["detector_s"] == min(r["walls_s"]) - min(r["predict_walls_s"])
    assert r["detector_share"] == r["detector_s"] / min(r["walls_s"])
    assert r["predict_pings_per_sec"] > 0


def test_school_serving_store_law_catches_a_changed_store(weights, surveys,
                                                          monkeypatch):
    """The store law compares what it should: a detection dropped from
    the store read-back shows as unequal."""
    from crimac_unet_tpu_torch.pipeline import school_eval
    orig = school_eval.detect_store_schools

    def drop(*a, **kw):
        out = orig(*a, **kw)
        return {ch: d[1:] for ch, d in out.items()}
    monkeypatch.setattr(school_eval, "detect_store_schools", drop)
    res = torch_school_serving_bench.run(
        weights[0], surveys["port"], "cpu", MODEL, passes=1,
        preload_n_pings=PRELOAD, log=lambda m: None)
    assert not any(res[arm]["store_equal"]
                   for arm in torch_school_serving_bench.ARMS)


# --------------------------------- item 3: post-processing sweep
SMALL_GRID = dict(thrs=(0.5, 0.8), areas=(1, 25), gaps=(0, 16))
# the sweep's weights: the classifier scaled by 6, which gives these
# seeded weights a few hundred detections an echogram at threshold 0.5
# (by 3 they give thousands of one-pixel fragments)
SWEEP_CLASSIFIER_SCALE = 6.0


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's run on a 2-echogram big held-out fixture (its live rows
    too) and the JAX package's from-store sweep over the same stores."""
    from crimac_unet_tpu.data.memmap_reader import get_echograms as jget
    from crimac_unet_tpu.pipeline.school_eval import (
        gt_boxes_by_category as jgt, school_eval_survey as jsurvey)
    sd = init_random_(build_unet(common.model_config(MODEL)),
                      torch.Generator().manual_seed(7)).state_dict()
    for k in ("conv_final.weight", "conv_final.bias"):
        sd[k] = sd[k] * SWEEP_CLASSIFIER_SCALE
    work = tmp_path_factory.mktemp("sweep")
    val = torch_school_ap_trained.ensure_big_val_fixture(work, n_echograms=2)
    pred_dir = work / "preds"
    port = torch_school_postproc_sweep.run(
        sd, val, pred_dir, "cpu", MODEL, preload_n_pings=PRELOAD,
        log=lambda m: None, **SMALL_GRID)
    readers = jget(years=[2016], path_to_echograms=val, minimum_shape=50)
    n_gt = {}
    for r in readers:              # scripts/school_postproc_sweep.py:103-107
        g = jgt(r, [27, 1])
        for code, name in ((27, "sandeel"), (1, "other")):
            n_gt[name] = n_gt.get(name, 0) + len(g[code])
    rows = []
    for thr in SMALL_GRID["thrs"]:
        for area in SMALL_GRID["areas"]:
            for gap in SMALL_GRID["gaps"]:
                m = jsurvey(None, readers, preload_n_pings=PRELOAD,
                            prob_threshold=thr, min_area=area, merge_gap=gap,
                            from_predictions=str(pred_dir))
                row = {"thr": thr, "min_area": area, "merge_gap": gap}
                for name, cm in m["categories"].items():
                    row[f"{name}_ap25"] = round(cm["ap"][0], 4)
                    row[f"{name}_ap50"] = round(cm["ap"][1], 4)
                    row[f"{name}_recall25"] = round(cm["recall"][0], 4)
                    row[f"{name}_ndet"] = cm["n_detections"]
                rows.append(row)

    def ok(r):                     # scripts/school_postproc_sweep.py:126-134
        return (r["sandeel_ndet"] <= 3 * n_gt["sandeel"]
                and r["other_ndet"] <= 3 * n_gt["other"])
    eligible = [r for r in rows if ok(r)] or rows
    best = max(eligible, key=lambda r: (r["sandeel_ap25"]
                                        + r["other_ap25"]) / 2)
    return port, {"n_gt": n_gt, "rows": rows, "chosen": best}


def test_sweep_rows_match_jax(sweep):
    port, jax = sweep
    assert port["n_gt"] == jax["n_gt"]
    assert port["rows"] == jax["rows"]
    assert port["chosen"] == jax["chosen"]
    assert port["baseline"]["sandeel_ndet"] > port["chosen"]["sandeel_ndet"]
    assert port["chosen"]["other_ndet"] > 0
    assert port["baseline"] == port["rows"][0]


def test_sweep_live_rows_equal_store_rows(sweep):
    """Item 2's law at the post-processing knobs: a live
    ``school_eval_survey`` at the baseline's and the chosen point's
    settings gives their rows."""
    port, _ = sweep
    for key in ("baseline", "chosen"):
        assert port["live"][key] == port[key]
    assert port["launches"]["sweep_predict"]["forwards"] > 0
    assert port["launches"]["sweep_live"]["forwards"] \
        == 2 * port["launches"]["sweep_predict"]["forwards"]


# ----------------------------------------- item 4: pooled metadata
def test_pooled_meta_first_losses_equal_across_arms():
    res = torch_pooled_meta_bench.run(
        "cpu", model={"depth": 3, "start_filts": 8, "patch_size": [64, 64],
                      "compute_dtype": "float32"},
        batch=2, steps=1, warmup=1, H=200, W=400, log=lambda m: None)
    first = res["first_loss"]
    assert np.isfinite(first["host"])
    assert abs(first["pooled"] - first["host"]) <= LOSS_RTOL * abs(
        first["host"])
    # the staged arm's resident batch is the host arm's first batch
    assert first["staged"] == first["host"]
    for arm in ("host", "pooled", "staged"):
        assert res[f"{arm}_losses_finite"] and res[f"{arm}_ms"] > 0
    assert res["speedup_pooled_vs_host"] > 0


def test_pooled_meta_config_is_the_jax_scripts():
    (jax,) = _jax_scripts("pooled_meta_bench")
    cfg = torch_pooled_meta_bench.bench_config()
    assert (torch_pooled_meta_bench.BATCH, torch_pooled_meta_bench.STEPS,
            torch_pooled_meta_bench.WARMUP) == (jax.BATCH, jax.STEPS,
                                                jax.WARMUP)
    assert cfg["meta_channels"] == jax.ALL_META
    assert cfg["patch_size"] == [jax.PATCH, jax.PATCH]
    assert cfg["frequencies"] == jax.FREQS
    assert cfg["train_dtype"] == cfg["compute_dtype"] == "bfloat16"


# ----------------------------------------- items 5-7: recipe configs
def _parsed_jax(cfg):
    from crimac_unet_tpu.config import parse_config_options
    return parse_config_options(cfg)


def _differing(port, jax):
    return {k for k in set(port) | set(jax) if port.get(k) != jax.get(k)}


@pytest.mark.parametrize("arm", list(torch_fast_recipe.ARMS))
def test_fast_config_matches_jax(arm, tmp_path):
    (fast,) = _jax_scripts("fast_recipe")
    memm = str(tmp_path)
    port = torch_fast_recipe.ARMS[arm](memm)
    jax = _parsed_jax(fast.ARMS[arm](memm))
    assert _differing(port, jax) <= PORT_ONLY_KEYS
    assert port["device"] == "cuda"


@pytest.mark.parametrize("late", [False, True], ids=["early", "late"])
def test_meta_config_matches_jax(late, tmp_path):
    fast, meta = _jax_scripts("fast_recipe", "meta_recipe")
    memm = str(tmp_path)
    jcfg = fast.fast_config(memm, 16, 0.01)     # scripts/meta_recipe.py:53-58
    jcfg["meta_channels"] = dict(meta.ALL_META)
    jcfg["late_meta_inject"] = late
    port = torch_meta_recipe.meta_config(memm, late)
    assert _differing(port, _parsed_jax(jcfg)) <= PORT_ONLY_KEYS


def test_fast_preset_is_the_b16_sqrt_arm(tmp_path, monkeypatch):
    """The port's ``config_fast_train.yaml`` holds the settings of the
    fast recipe's ``b16_sqrt`` arm, and a changed arm shows."""
    assert torch_fast_recipe.preset_differences(str(tmp_path)) == {}
    arms = dict(torch_fast_recipe.ARMS, b16_sqrt=lambda memm, **kw:
                torch_fast_recipe.fast_config(memm, 16, 0.02, **kw))
    monkeypatch.setattr(torch_fast_recipe, "ARMS", arms)
    assert torch_fast_recipe.preset_differences(str(tmp_path)) == {
        "lr": (0.02, 0.01)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r3_config_matches_jax(dtype, tmp_path):
    (r3,) = _jax_scripts("r3_tpu_session")
    memm = str(tmp_path)
    port = torch_r3_session.recipe_config(memm, dtype)
    assert _differing(port, _parsed_jax(r3.recipe_config(memm, dtype))) \
        <= PORT_ONLY_KEYS
    assert port["train_dtype"] == dtype


def test_recipe_arm_trains_and_saves_jax_keys(tmp_path):
    """Two arms cut to one validation on the CPU, on a small fixture in
    the recipe fixture's place: the JAX scripts' keys saved and merged
    into one ``--out``, the summaries' counts."""
    import json
    _small(tmp_path)
    small = {"depth": 2, "start_filts": 4, "patch_size": [64, 64],
             "device": "cpu"}
    out = tmp_path / "res.json"
    cut = {"iterations": 4, "log_step": 4, "test_iter": 2}
    res = torch_fast_recipe.run_arm(tmp_path, out, "b16_sqrt", cut=cut,
                                    **small)
    assert res["steps"] == 4 and res["val_steps"] == 2
    assert res["losses_finite"] and res["pooled"]
    assert res["lr"] == 0.01 and res["batch"] == 16
    assert res["launches"]["forwards"] == 0
    meta = torch_meta_recipe.run(tmp_path, out, True, cut=cut, **small)
    assert meta["pooled_meta"] and meta["losses_finite"]
    saved = json.loads(out.read_text())
    assert set(saved["fast_b16_sqrt"]) == {"best_F1", "wall_min", "steps",
                                           "batch", "lr", "samples", "ckpt"}
    assert set(saved["meta_late"]) == {"best_F1", "wall_min", "steps",
                                       "pooled_meta", "samples", "ckpt"}


def _small(root):
    """The recipe fixture's layout (2017 train, 2016 validation) at a
    CPU test's size."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    memm = Path(root) / "train_memm"
    make_survey_dir(memm, year=2017, n_echograms=2, H=160, W=300, seed=41,
                    n_schools=3)
    make_survey_dir(memm, year=2016, n_echograms=1, H=160, W=300, seed=42,
                    n_schools=3)
    return memm


def test_meta_recipe_raises_when_the_pooled_path_is_off(tmp_path):
    """Where the JAX script only logs, the port raises."""
    _small(tmp_path)
    with pytest.raises(RuntimeError, match="pooled metadata path"):
        torch_meta_recipe.run(
            tmp_path, tmp_path / "res.json", False,
            cut={"iterations": 2, "log_step": 2, "test_iter": 1},
            depth=2, start_filts=4, patch_size=[64, 64], device="cpu",
            use_device_pool=False)


# ----------------------------------------------- item 8: static grid
SG_MODEL = {"depth": 2, "start_filts": 4, "patch_size": [64, 64],
            "patch_overlap": 10, "compute_dtype": "float32", "fwd_batch": 8,
            "preload_n_pings": 250}
SG_ECHOS = [(440, 650, 0.35), (360, 650, 0.9), (440, 375, 0.6)]


@pytest.fixture(scope="module")
def static_grid(tmp_path_factory):
    work = tmp_path_factory.mktemp("static_grid")
    return work, torch_static_grid.run("cpu", work, SG_MODEL, SG_ECHOS)


def test_static_grid_arms(static_grid):
    work, res = static_grid
    # the seabed caches come with the survey, not with the first arm
    dirs = [d for d in (Path(work) / "static_grid_survey").iterdir()
            if d.is_dir()]
    assert len(dirs) == 3 and all((d / "seabed.npy").is_file()
                                  for d in dirs)
    assert len(res["static"]["distinct_predict_sigs"]) == 1
    assert len(res["dynamic"]["distinct_predict_sigs"]) > 1
    assert len(res["static"]["distinct_mask_sigs"]) == 1
    assert res["n_stores"] == 3
    assert res["bit_identical"] and res["write_masks_identical"]
    assert res["max_abs_prob_diff"] == 0.0
    assert res["order"] == "static,dynamic"
    for arm in ("static", "dynamic"):
        assert res[arm]["n_chunks"] > 0 and res[arm]["conv_shapes"] > 0
        assert res[arm]["forwards"] > 0 and res[arm]["cold_wall_s"] > 0
        assert res[arm]["sub_batches"] and all(
            0 < b <= SG_MODEL["fwd_batch"] for b in res[arm]["sub_batches"])


def test_static_grid_dynamic_first(static_grid):
    """``order="dynamic,static"``: the same grids, sub-batches and stores
    as the default order."""
    work, first = static_grid
    res = torch_static_grid.run("cpu", Path(work) / "dynamic_first",
                                SG_MODEL, SG_ECHOS, order="dynamic,static")
    assert res["order"] == "dynamic,static"
    for arm in ("static", "dynamic"):
        for key in ("distinct_predict_sigs", "distinct_mask_sigs",
                    "sub_batches", "n_chunks", "forwards", "conv_shapes"):
            assert res[arm][key] == first[arm][key], (arm, key)
    assert res["bit_identical"] and res["n_stores"] == 3


def test_static_grid_signatures_match_jax(static_grid, tmp_path):
    """The JAX runner on the same fixture, spied as
    scripts/static_grid_tpu.py:97-103 spies it, runs the same (R, C)
    grids in each arm."""
    import jax

    from crimac_unet_tpu.data.memmap_reader import get_echograms as jget
    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    from crimac_unet_tpu.pipeline.inference import GriddedRunner
    from crimac_unet_tpu.pipeline.save_predict import run_save_predictions
    work, res = static_grid
    fixture = Path(work) / "static_grid_survey"
    for static in (True, False):
        cfg = torch_static_grid.arm_config(static, SG_MODEL)
        model = jax_build_unet(cfg)
        v = model.init(jax.random.PRNGKey(0),
                       np.zeros((1, 64, 64, 4), np.float32), train=False)
        runner = GriddedRunner(model, v, cfg)
        sigs = []
        real = runner._predict_patches

        def spy(variables, data_slab, y0s, x0s, border_slab, meta_slab,
                consts, R, C, *rest, real=real, sigs=sigs):
            sigs.append((R, C))
            return real(variables, data_slab, y0s, x0s, border_slab,
                        meta_slab, consts, R, C, *rest)
        runner._predict_patches = spy

        class Data:
            def get_survey_readers(self, survey):
                return jget(years=[2017], path_to_echograms=str(fixture),
                            frequencies=cfg["frequencies"],
                            minimum_shape=cfg["patch_size"][0])
        out = tmp_path / f"jax_{static}"
        out.mkdir()
        run_save_predictions(cfg, runner, Data(), str(out))
        arm = res["static" if static else "dynamic"]
        assert sorted(set(sigs)) == [tuple(s) for s in
                                     arm["distinct_predict_sigs"]]
        assert len(sigs) == arm["n_chunks"]


# ------------------------------------------------------ no card, no run
@pytest.mark.parametrize("script", [
    "eval_quant_bench", "school_serving_bench", "school_postproc_sweep",
    "pooled_meta_bench", "r3_session", "fast_recipe", "meta_recipe",
    "static_grid"])
def test_scripts_raise_without_a_card(script, monkeypatch, tmp_path):
    """``--device`` defaults to cuda, which raises without a card before
    any fixture is written; no script falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"scripts.torch_{script}")
    argv = [] if script == "pooled_meta_bench" else ["--work", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())
