"""Two gloo ranks against one rank of the port, on the CPU.

Each module fixture spawns the two ranks once (``python
tests/test_torch_multirank.py <suite> <rank> 2 <port> <dir>``, every
process with its own timeout) and runs a suite of cases in them with
``mesh_devices: 2``; the same suite runs in this process alone as the
reference.  Depth 2-3, start_filts 4, float32.  Stated tolerances:

- patch prediction (memmap and zarr stores, ``transfer_dtype: uint8``):
  the written zero set identical, probabilities within 2e-3 (the JAX
  package's bound for a re-partitioned batch);
- slab prediction with early and late metadata, the ping axis split over
  the ranks with the receptive-field halo: the float32 probabilities
  within 2e-5; a halo one pooling step smaller misses that bound;
- evaluation histograms (memmap and zarr) bit-equal;
- ``run_training`` (host crops, and pooled with metadata; augmentation
  on): losses and final parameters within rtol 1e-3 / atol 1e-4, rank 0
  alone writing ``best``/``last.msgpack``;
- ranks without a mesh (a runner with ``mesh_devices: 1``, a batch of 3
  the 2-rank mesh does not divide): every rank computes the whole, rank
  0 of the process group alone writes the stores, the metrics CSVs
  (evaluation, school detection) and the checkpoints;
- the 2-rank train step (augmentation the identity) against the JAX
  package's step on a 2-device mesh run in float64: each parameter's
  update within 1e-3 relative in max-norm, as
  tests/test_torch_train_step.py holds one device.

Every rank ends with the same outputs (checked on the slab outputs and
the histograms).
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.config import (META_CHANNELS_ALL,
                                         parse_config_options)
from crimac_unet_tpu_torch.data.fixtures import (make_survey_dir,
                                                 make_zarr_survey)
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import (build_unet, init_random_,
                                               init_train_)
from crimac_unet_tpu_torch.ops import augment, metrics
from crimac_unet_tpu_torch.parallel import mesh as pmesh
from crimac_unet_tpu_torch.parallel.multihost_check import (free_port,
                                                            run_ranks)
from crimac_unet_tpu_torch.pipeline import engine, train
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
from crimac_unet_tpu_torch.pipeline.predict import (
    predict_reader, save_reader_predictions_memm,
    save_survey_predictions_zarr)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.pipeline.school_eval import school_eval_survey

TIMEOUT = 240
SERVE = {"patch_size": [32, 32], "patch_overlap": 4,
         "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 3,
         "start_filts": 4, "compute_dtype": "float32", "device": "cpu",
         "preload_n_pings": 150, "alignment_warning": False}
STEP = {"patch_size": [32, 32], "frequencies": [18, 38, 120, 200],
        "lr": 0.005, "lr_step": 1000, "lr_reduction": 0.5, "momentum": 0.95,
        "depth": 2, "start_filts": 4, "compute_dtype": "float32",
        "train_dtype": "float32", "loss_type": "CE"}


# ------------------------------------------------------------ the suites
def _runner(cfg, mesh_devices, seed=3):
    """Seeded random weights with the conv kernels doubled: at torch's
    default scale the deepest paths of a fresh network fade below float32
    resolution, so a halo that cuts the receptive field would go unseen;
    doubled, the field's far edge carries signal as a trained model's
    does."""
    net = init_random_(build_unet(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim == 4:
                p.mul_(2.0)
    return GriddedRunner(build_unet(cfg), net.state_dict(),
                         dict(cfg, mesh_devices=mesh_devices))


def _record_slab(runner):
    """Keep the float32 output of every ``_predict_slab`` call."""
    rec, inner = [], runner._predict_slab

    def wrapped(*a, **k):
        out = inner(*a, **k)
        rec.append(out.numpy().copy())
        return out
    runner._predict_slab = wrapped
    return rec


def serving_suite(work: Path, out: Path, mesh_devices: int, rank: int):
    memm = Echogram(str(next((work / "memm").iterdir())))
    zarr = DataReaderZarr(str(work / "zarr" / "S2017843_sv.zarr"))
    res = {}
    u8 = dict(SERVE, transfer_dtype="uint8")
    save_reader_predictions_memm(
        _runner(u8, mesh_devices), memm, str(out / f"memm_r{rank}.npy"),
        preload_n_pings=150)
    save_survey_predictions_zarr(
        _runner(u8, mesh_devices), zarr, str(out / f"zarr_r{rank}.zarr"),
        preload_n_pings=150)
    # no mesh: every rank of the group predicts the whole, rank 0 writes
    save_reader_predictions_memm(
        _runner(u8, 1), memm, str(out / f"memm1_r{rank}.npy"),
        preload_n_pings=150)
    save_survey_predictions_zarr(
        _runner(u8, 1), zarr, str(out / f"zarr1_r{rank}.zarr"),
        preload_n_pings=150)
    evaluate_survey(_runner(u8, 1), [memm], "all",
                    save_path_metrics=str(out / f"eval1_r{rank}.csv"))
    school_eval_survey(_runner(u8, 1), [memm], preload_n_pings=150,
                       save_path_metrics=str(out / f"school1_r{rank}.csv"))
    meta = dict(SERVE, infer_mode="slab", transfer_dtype="float32",
                meta_channels=META_CHANNELS_ALL)
    for name, cfg, shrink in (("slab_early", meta, 0),
                              ("slab_late", dict(meta,
                                                 late_meta_inject=True), 0),
                              ("slab_small_halo", meta, 1)):
        runner = _runner(cfg, mesh_devices)
        runner.slab_halo -= shrink * 2 ** (runner.model.depth - 1)
        rec = _record_slab(runner)
        for _ in predict_reader(runner, memm, 150):
            pass
        res.update({f"{name}_{i}": a for i, a in enumerate(rec)})
    for name, reader, td in (("eval_memm", memm, "float32"),
                             ("eval_zarr", zarr, "uint8")):
        runner = _runner(dict(SERVE, transfer_dtype=td), mesh_devices)
        res[name] = evaluate_reader(runner, reader, metrics.new_histogram())
    np.savez(out / f"serving_r{rank}.npz", **res)


class _Logger:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step):
        self.rows.append((tag, float(value), int(global_step)))


def _train_cfg(work, **kw):
    return parse_config_options(dict({
        "path_to_echograms": str(work / "train"), "patch_size": [32, 32],
        "depth": 2, "start_filts": 4, "batch_size": 4, "iterations": 4,
        "test_iter": 2, "log_step": 2, "lr_step": 2, "num_workers": 2,
        "train_surveys": [2017], "validation_surveys": [2016],
        "device": "cpu", "train_dtype": "float32"}, **kw))


def _step_batch():
    rng = np.random.RandomState(5)
    data = rng.lognormal(np.log(3e-6), 1.5, (4, 4, 32, 32)).astype(
        np.float32)
    labels = rng.choice([0, 27, 1, -100], size=(4, 32, 32),
                        p=[0.6, 0.2, 0.15, 0.05]).astype(np.int32)
    return data, labels


def training_suite(work: Path, out: Path, mesh_devices: int, rank: int):
    saves = []
    inner_save, inner_aug = engine.save_checkpoint, augment.augment_train
    engine.save_checkpoint = lambda path, *a, **k: (
        saves.append(Path(path).name), inner_save(path, *a, **k))
    try:
        res = _training_cases(work, out, mesh_devices)
    finally:
        engine.save_checkpoint = inner_save
        augment.augment_train = inner_aug
    res["saves"] = saves
    np.savez(out / f"training_r{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})


def _training_cases(work, out, mesh_devices):
    res = {}
    for name, kw in (("plain", {"use_device_pool": False}),
                     ("pooled_meta", {"use_device_pool": True,
                                      "meta_channels": META_CHANNELS_ALL})):
        log = _Logger()
        sp = train.run_training(
            _train_cfg(work, mesh_devices=mesh_devices, **kw),
            out / f"ck_{name}_m{mesh_devices}", logger=log, progress=False)
        res[f"{name}_loss"] = [v for t, v, _ in log.rows if t == "train/loss"]
        res[f"{name}_f1"] = [v for t, v, _ in log.rows
                             if t == "test/F1_score"]
        for n, p in sp.model.named_parameters():
            res[f"{name}_param_{n}"] = p.detach().numpy().copy()

    # a batch of 3 the 2-rank mesh does not divide: every rank trains the
    # whole batch alone, rank 0 of the group writes
    log = _Logger()
    rank = torch.distributed.get_rank() \
        if torch.distributed.is_initialized() else 0
    sp = train.run_training(
        _train_cfg(work, mesh_devices=mesh_devices, batch_size=3,
                   use_device_pool=False),
        out / f"ck_fallback_m{mesh_devices}_r{rank}", logger=log,
        progress=False)
    assert sp.mesh is None
    res["fallback_loss"] = [v for t, v, _ in log.rows if t == "train/loss"]
    for n, p in sp.model.named_parameters():
        res[f"fallback_param_{n}"] = p.detach().numpy().copy()

    # one step with the augmentation the identity, for the JAX mesh step
    augment.augment_train = lambda gen, d, lab, **kw: (d, lab)
    net = init_train_(build_unet(STEP), torch.Generator().manual_seed(0))
    mesh = pmesh.get_mesh(mesh_devices)
    state = engine.init_train_state(net, STEP)
    data, labels = (torch.from_numpy(a) for a in _step_batch())
    loss = engine.make_train_step(STEP, mesh)(
        state, pmesh.shard_rows(mesh, data), pmesh.shard_rows(mesh, labels),
        None)
    res["step_loss"] = float(loss)
    for n, p in net.named_parameters():
        res[f"step_param_{n}"] = p.detach().numpy().copy()
    return res


SUITES = {"serving": serving_suite, "training": training_suite}


def _spawn(suite, work, out):
    port = free_port()
    run_ranks(lambda r: [sys.executable, __file__, suite, str(r), "2",
                         str(port), str(work), str(out)], 2, TIMEOUT)
    ref = out / "ref"
    ref.mkdir()
    SUITES[suite](work, ref, 1, 0)
    return {"r0": np.load(out / f"{suite}_r0.npz"),
            "r1": np.load(out / f"{suite}_r1.npz"),
            "ref": np.load(ref / f"{suite}_r0.npz"), "out": out, "ref_dir": ref}


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    work = tmp_path_factory.mktemp("multirank_serving")
    make_survey_dir(work / "memm", year=2017, n_echograms=1, H=100, W=300,
                    seed=31)
    make_zarr_survey(work / "zarr", year=2017, n_echograms=1, H=100, W=300,
                     seed=32)
    return _spawn("serving", work, work)


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    work = tmp_path_factory.mktemp("multirank_training")
    make_survey_dir(work / "train", year=2017, n_echograms=2, H=80, W=200,
                    seed=21)
    make_survey_dir(work / "train", year=2016, n_echograms=1, H=80, W=200,
                    seed=22)
    return _spawn("training", work, work)


# ------------------------------------------------------------------ tests
def _zarr_annotation(path):
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    return ZGroup.open(str(path))["annotation"][:]


@pytest.mark.parametrize("kind", ["memm", "zarr"])
def test_two_rank_patch_prediction_matches_one_rank(serving, kind):
    out, ref = serving["out"], serving["ref_dir"]
    if kind == "memm":
        got, want = np.load(out / "memm_r0.npy"), np.load(ref / "memm_r0.npy")
    else:
        got = _zarr_annotation(out / "zarr_r0.zarr")
        want = _zarr_annotation(ref / "zarr_r0.zarr")
    assert got.shape == want.shape and (want != 0).any()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_rank_zero_alone_writes_the_stores(serving):
    out = serving["out"]
    assert (out / "memm_r0.npy").is_file() and (out / "zarr_r0.zarr").is_dir()
    assert not (out / "memm_r1.npy").exists()
    assert not (out / "zarr_r1.zarr").exists()


def test_rank_zero_alone_writes_without_a_mesh(serving):
    """``mesh_devices: 1`` in a group of 2: both ranks predict and
    evaluate the whole survey; rank 0 writes what one rank writes, rank 1
    writes nothing."""
    out, ref = serving["out"], serving["ref_dir"]
    np.testing.assert_array_equal(np.load(out / "memm1_r0.npy"),
                                  np.load(ref / "memm1_r0.npy"))
    np.testing.assert_array_equal(_zarr_annotation(out / "zarr1_r0.zarr"),
                                  _zarr_annotation(ref / "zarr1_r0.zarr"))
    for name in ("eval1_r0.csv", "school1_r0.csv"):
        assert (out / name).read_text() == (ref / name).read_text()
    for name in ("memm1_r1.npy", "zarr1_r1.zarr", "eval1_r1.csv",
                 "school1_r1.csv"):
        assert not (out / name).exists(), name


def _slabs(res, name):
    keys = sorted((k for k in res.files if k.startswith(name + "_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [res[k] for k in keys]


@pytest.mark.parametrize("name", ["slab_early", "slab_late"])
def test_two_rank_slab_prediction_matches_one_rank(serving, name):
    got, want = _slabs(serving["r0"], name), _slabs(serving["ref"], name)
    assert len(got) == len(want) >= 2
    for g, w, g1 in zip(got, want, _slabs(serving["r1"], name)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(g, g1)


def test_slab_halo_one_step_smaller_misses_the_bound(serving):
    """The halo is the receptive-field radius rounded up to the pooling
    step; one step less lets the window's edge reach interior outputs."""
    got = _slabs(serving["r0"], "slab_small_halo")
    want = _slabs(serving["ref"], "slab_small_halo")
    worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert worst > 2e-5, worst


@pytest.mark.parametrize("name", ["eval_memm", "eval_zarr"])
def test_two_rank_eval_histogram_bit_equal(serving, name):
    want = serving["ref"][name]
    assert want.sum() > 0
    np.testing.assert_array_equal(serving["r0"][name], want)
    np.testing.assert_array_equal(serving["r1"][name], want)


@pytest.mark.parametrize("name", ["plain", "pooled_meta"])
def test_two_rank_training_matches_one_rank(training, name):
    got, want = training["r0"], training["ref"]
    assert len(want[f"{name}_loss"]) == 4 and len(want[f"{name}_f1"]) == 2
    np.testing.assert_allclose(got[f"{name}_loss"], want[f"{name}_loss"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(training["r1"][f"{name}_loss"].size, 0)
    np.testing.assert_allclose(got[f"{name}_f1"], want[f"{name}_f1"],
                               rtol=1e-3, atol=1e-3)
    keys = [k for k in want.files if k.startswith(f"{name}_param_")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(got[k], training["r1"][k])


def test_two_rank_training_checkpoints_written_once(training):
    out = training["out"]
    saved = list(training["r0"]["saves"])
    assert saved.count("last.msgpack") == 3 and "best.msgpack" in saved
    assert training["r1"]["saves"].size == 0
    for name in ("plain", "pooled_meta", "fallback"):
        d = out / (f"ck_{name}_m2" if name != "fallback"
                   else "ck_fallback_m2_r0")
        for f in ("best.msgpack", "last.msgpack"):
            assert (d / f).is_file()
    assert not any((out / "ck_fallback_m2_r1").glob("*"))


def test_batch_the_mesh_does_not_divide_trains_alone_on_every_rank(
        training):
    """A batch of 3 over 2 ranks: each rank trains the whole batch
    without collectives, as one process does; rank 0 alone logs."""
    got, want = training["r0"], training["ref"]
    assert len(want["fallback_loss"]) == 4
    np.testing.assert_allclose(got["fallback_loss"], want["fallback_loss"],
                               rtol=1e-3, atol=1e-4)
    assert training["r1"]["fallback_loss"].size == 0
    keys = [k for k in want.files if k.startswith("fallback_param_")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(got[k], training["r1"][k])


_BIAS_BEFORE_BN = re.compile(r"(main\.[03]|conv[12])\.bias$")


def test_two_rank_step_matches_jax_two_device_mesh(training, monkeypatch):
    """The port's step on 2 gloo ranks against the JAX package's step on
    a 2-device mesh (float64, the conftest's virtual CPU devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    from crimac_unet_tpu.ops import augment as jax_augment
    from crimac_unet_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from crimac_unet_tpu.pipeline import engine as jax_engine
    from crimac_unet_tpu_torch.models.weights import (flax_params_to_torch,
                                                      torch_to_flax_variables)

    monkeypatch.setattr(jax_augment, "augment_train",
                        lambda key, d, lab: (d, lab))
    net = init_train_(build_unet(STEP), torch.Generator().manual_seed(0))
    p0 = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    data, labels = _step_batch()
    with jax.enable_x64(True):
        cfg64 = dict(STEP, compute_dtype="float64", train_dtype="float64")
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   torch_to_flax_variables(net.state_dict()))
        jmodel = jax_build_unet(cfg64)
        jstate = jax_engine.init_train_state(jmodel, cfg64,
                                             jax.random.PRNGKey(0),
                                             variables=v)
        shard = NamedSharding(jax_get_mesh(2), P("data"))
        jstate, jloss = jax_engine.make_train_step(jmodel, cfg64)(
            jstate, jax.device_put(data, shard),
            jax.device_put(labels, shard), jax.random.PRNGKey(0))
        jp1 = flax_params_to_torch(jax.tree_util.tree_map(
            lambda a: np.array(a, np.float64), jstate.params))
    got = training["r0"]
    assert abs(float(got["step_loss"]) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    for name, w0 in p0.items():
        up = got[f"step_param_{name}"] - w0
        ref = jp1[name] - w0
        scale_name = name[:-4] + "weight" if _BIAS_BEFORE_BN.search(name) \
            else name
        scale = np.max(np.abs(jp1[scale_name] - p0[scale_name]))
        ulp = np.max(np.spacing(np.abs(w0)))
        assert np.max(np.abs(up - ref)) <= 1e-3 * scale + ulp, name


if __name__ == "__main__":
    suite, rank, world, port = sys.argv[1], *map(int, sys.argv[2:5])
    work, out = Path(sys.argv[5]), Path(sys.argv[6])
    torch.set_num_threads(1)
    pmesh.init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank, device="cpu",
                           timeout_s=TIMEOUT)
    try:
        SUITES[suite](work, out, world, rank)
    finally:
        pmesh.shutdown_distributed()
    print(json.dumps({"suite": suite, "rank": rank}))
