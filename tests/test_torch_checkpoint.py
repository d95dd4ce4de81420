"""Checkpoints shared by the port and the JAX package (flax msgpack).

- The port's msgpack codec reads what ``flax.serialization`` writes and
  writes the bytes flax writes for the same tree; it raises on flax's
  chunked-array form and on types it does not know.
- A JAX ``save_checkpoint`` file served by the port (``run_save_predictions``
  on a memmap survey) gives probabilities bit-equal to the ``.pt`` route.
- flax's ``msgpack_restore`` and the JAX package's template restore and
  ``resume_from`` read the port's file into equal arrays.
- The port resumes a JAX TrainState checkpoint (weights, statistics,
  momentum, step) and its next step matches the JAX package's resumed step
  (float32: loss within 1e-5 relative, updates within 5e-2 relative in
  max-norm, the float32-to-float32 bound of tests/test_torch_train_step.py).
- The ``.json`` sidecar is written before the checkpoint, and a failed
  write leaves the previous checkpoint intact.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import augment as jax_augment
from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu.pipeline.segpipe import SegPipeUNet as JaxSegPipe
from crimac_unet_tpu_torch.config import parse_config_options
from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
from crimac_unet_tpu_torch.data.partition import make_partition
from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
from crimac_unet_tpu_torch.models.weights import (flax_params_to_torch,
                                                  load_checkpoint,
                                                  torch_to_flax_variables)
from crimac_unet_tpu_torch.ops import augment
from crimac_unet_tpu_torch.pipeline import engine
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.pipeline.save_predict import run_save_predictions
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
from crimac_unet_tpu_torch.utils import flax_msgpack

CFG = {"patch_size": [64, 64], "depth": 3, "start_filts": 8,
       "frequencies": [18, 38, 120, 200], "lr": 0.005, "lr_reduction": 0.5,
       "lr_step": 1000, "momentum": 0.95, "loss_type": "CE",
       "class_weights": [10.0, 300.0, 250.0], "random_seed": 10,
       "compute_dtype": "float32", "train_dtype": "float32",
       "mesh_devices": 1, "log_step": 100, "device": "cpu"}


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"b": {"kernel": rng.randn(3, 3, 2, 4).astype(
                np.float32), "bias": np.zeros(4, np.float32)},
                       "a": rng.randn(7).astype(np.float64)},
            "step": np.asarray(12, np.int32), "i8": np.arange(-3, 3,
                                                               dtype=np.int8),
            "scalar": np.float32(2.5), "u16": np.uint16(9), "n": 300,
            "neg": -70000, "f": -1.25, "s": "x" * 40, "t": True,
            "none": None, "empty": np.zeros((0, 5), np.float32),
            "big": rng.randn(70000).astype(np.float32)}


def _assert_tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_matches_flax(seed):
    tree = _tree(seed)
    flax_bytes = serialization.msgpack_serialize(dict(tree))
    assert flax_msgpack.packb(tree) == flax_bytes
    _assert_tree_equal(flax_msgpack.unpackb(flax_bytes),
                       serialization.msgpack_restore(flax_bytes))


@pytest.mark.parametrize("case", ["chunked", "ext", "key", "trailing",
                                  "truncated", "bfloat16"])
def test_codec_raises_on_what_it_does_not_know(case):
    if case == "chunked":
        data = msgpack.packb({"a": {"__msgpack_chunked_array__": True}})
    elif case == "ext":
        data = msgpack.packb({"a": msgpack.ExtType(2, b"\x00")})
    elif case == "key":
        data = msgpack.packb({1: 2})
    elif case == "trailing":
        data = msgpack.packb({"a": 1}) + b"\x00"
    elif case == "truncated":
        data = serialization.msgpack_serialize({"a": np.zeros(9)})[:-3]
    else:
        data = serialization.msgpack_serialize(
            {"a": jnp.zeros(3, jnp.bfloat16)})
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(data)


def _jax_variables(seed=3):
    net = init_train_(build_unet(CFG), torch.Generator().manual_seed(seed))
    for m in net.modules():            # statistics away from identity
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    return jax.tree_util.tree_map(jnp.asarray, torch_to_flax_variables(
        net.state_dict()))


def test_jax_msgpack_served_by_port_equals_pt_route(tmp_path):
    v = _jax_variables()
    jax_engine.save_checkpoint(tmp_path / "best.msgpack", v)
    save_torch_checkpoint(jax.tree_util.tree_map(np.asarray, v),
                          tmp_path / "best.pt")
    make_survey_dir(tmp_path / "memm", year=2017, n_echograms=1, H=130,
                    W=260, seed=9)
    cfg = parse_config_options(dict(
        CFG, patch_overlap=8, fwd_batch=8, preload_n_pings=200,
        save_prediction_surveys=[2017], transfer_dtype="float32",
        output_dtype="float16"))
    outs = []
    for name in ("best.msgpack", "best.pt"):
        out = tmp_path / ("out_" + name.replace(".", "_"))
        out.mkdir()
        runner = GriddedRunner(build_unet(cfg),
                               load_checkpoint(tmp_path / name), cfg,
                               device="cpu")
        data_obj = make_partition(
            dict(cfg, path_to_echograms=str(tmp_path / "memm")))
        run_save_predictions(cfg, runner, data_obj, str(out))
        (pred,) = out.glob("*_pred.npy")
        outs.append(np.load(pred))
    assert (outs[0] != 0).any()
    np.testing.assert_array_equal(outs[0], outs[1])


def _trained_segpipe(tmp_path, steps=2):
    sp = SegPipeUNet(CFG, checkpoint_dir=tmp_path / "ck")
    sp.init_model()
    rng = np.random.RandomState(4)
    sp.generator = torch.Generator().manual_seed(0)
    for _ in range(steps):
        data = rng.lognormal(np.log(3e-6), 1.5, (2, 4, 64, 64)).astype(
            np.float32)
        labels = np.zeros((2, 64, 64), np.int32)
        labels[:, 10:30, 10:40] = 27
        labels[:, 40:50, 5:20] = 1
        sp.train_step({"data": torch.from_numpy(data),
                       "labels": torch.from_numpy(labels)})
    return sp


def test_flax_reads_port_checkpoint(tmp_path):
    sp = _trained_segpipe(tmp_path)
    path = tmp_path / "ck" / "last.msgpack"
    engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.25})
    with open(path, "rb") as f:
        data = f.read()
    tree = serialization.msgpack_restore(data)
    want = engine.checkpoint_payload(sp.state)
    _assert_tree_equal(tree, want)
    assert int(tree["step"]) == 2 == int(tree["opt_state"]["1"]["count"])
    # the momentum trace is the torch SGD buffers in the flax layout
    trace = flax_params_to_torch(tree["opt_state"]["0"]["trace"])
    for name, p in sp.model.named_parameters():
        np.testing.assert_array_equal(
            trace[name], sp.state.optimizer.state[p]["momentum_buffer"]
            .numpy())
    # the JAX package restores it against its own TrainState template and
    # resumes training from it
    jsp = JaxSegPipe(dict(CFG, device=None), checkpoint_dir=None)
    jstate = jsp.resume_from(path)
    assert int(jstate.step) == 2 and jsp.best_F1_val == 0.25
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, jstate.params),
                       want["params"])
    _assert_tree_equal(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].trace),
        want["opt_state"]["0"]["trace"])


def test_port_resumes_jax_checkpoint_and_steps_like_jax(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(jax_augment, "augment_train",
                        lambda key, d, lab: (d, lab))
    monkeypatch.setattr(augment, "augment_train",
                        lambda gen, d, lab: (d, lab))
    jmodel = jax_build_unet(CFG)
    jstate = jax_engine.init_train_state(jmodel, CFG, jax.random.PRNGKey(0),
                                         variables=_jax_variables(5))
    jstep = jax_engine.make_train_step(jmodel, CFG)
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(2):
        data = rng.lognormal(np.log(3e-6), 1.5, (2, 4, 64, 64)).astype(
            np.float32)
        labels = np.zeros((2, 64, 64), np.int32)
        labels[:, 12:34, 20:44] = 27
        labels[:, 44:56, 8:30] = 1
        batches.append((data, labels))
    jstate, _ = jstep(jstate, jnp.asarray(batches[0][0]),
                      jnp.asarray(batches[0][1]), jax.random.PRNGKey(0))
    path = tmp_path / "jax_last.msgpack"
    jax_engine.save_checkpoint(path, jstate, extras={"best_f1": 0.5})

    sp = SegPipeUNet(CFG)
    sp.resume_from(path)
    assert sp.state.step == 1 and sp.best_F1_val == 0.5
    jp0 = flax_params_to_torch(jax.tree_util.tree_map(np.array,
                                                      jstate.params))
    p0 = {n: p.detach().numpy().copy() for n, p in
          sp.model.named_parameters()}
    for name in p0:
        np.testing.assert_array_equal(p0[name], jp0[name])
    jstate, jloss = jstep(jstate, jnp.asarray(batches[1][0]),
                          jnp.asarray(batches[1][1]), jax.random.PRNGKey(1))
    loss = sp.train_step({"data": torch.from_numpy(batches[1][0]),
                          "labels": torch.from_numpy(batches[1][1])})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jp1 = flax_params_to_torch(jax.tree_util.tree_map(np.array,
                                                      jstate.params))
    for name, p in sp.model.named_parameters():
        up, jup = p.detach().numpy() - p0[name], jp1[name] - jp0[name]
        if name.endswith("bias") and (".main.0." in name or ".main.3." in name
                                      or ".conv" in name):
            continue   # ahead of a BatchNorm: zero gradient, rounding noise
        assert np.max(np.abs(up - jup)) <= 5e-2 * np.max(np.abs(jup)) + \
            np.max(np.spacing(np.abs(p0[name]))), name
    assert sp.state.step == int(jstate.step) == 2


def test_sidecar_first_and_atomic_write(tmp_path, monkeypatch):
    sp = _trained_segpipe(tmp_path, steps=1)
    path = tmp_path / "ck" / "best.msgpack"
    engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.1})
    good = path.read_bytes()
    order = []
    real_replace = os.replace

    def spy(src, dst):
        order.append(os.path.basename(str(dst)))
        real_replace(src, dst)
    monkeypatch.setattr(os, "replace", spy)
    engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.2})
    assert order == ["best.msgpack.json", "best.msgpack"]
    assert engine.load_checkpoint_extras(path) == {"best_f1": 0.2}

    def boom(tree):
        raise RuntimeError("disk full")
    monkeypatch.setattr(flax_msgpack, "packb", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.3})
    assert path.read_bytes() == good          # the old checkpoint holds
    assert engine.load_checkpoint_extras(tmp_path / "none") == {}
    with pytest.raises(ValueError, match="TRAINING resume"):
        SegPipeUNet(CFG).resume_from(tmp_path / "model.pt")


@pytest.mark.parametrize("entry", ["docker", "evaluate"])
def test_jax_msgpack_through_docker_and_evaluate(tmp_path, monkeypatch,
                                                 entry):
    """The docker entry (a zarr store) and the evaluate CLI (the metrics
    CSV) give the same outputs from a JAX ``best.msgpack`` as from its
    ``.pt`` export."""
    import yaml
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    from crimac_unet_tpu_torch.pipeline import dockerscript, evaluate
    v = _jax_variables(7)
    jax_engine.save_checkpoint(tmp_path / "run" / "best.msgpack", v)
    save_torch_checkpoint(jax.tree_util.tree_map(np.asarray, v),
                          tmp_path / "run" / "best.pt")
    cfg = dict(CFG, patch_overlap=8, fwd_batch=8, preload_n_pings=200,
               transfer_dtype="float32")
    outs = {}
    if entry == "docker":
        sv = make_zarr_survey(tmp_path / "z", year=2017, n_echograms=1,
                              H=120, W=260, seed=2)
        freq = ZGroup.open(sv)["frequency"]
        freq[:] = freq[:] * 1000          # production stores carry Hz
        (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        monkeypatch.setenv("SURVEY_PATH", str(sv))
        monkeypatch.setenv("CONFIG_PATH", str(tmp_path / "cfg.yaml"))
        monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
        for name in ("best.msgpack", "best.pt"):
            monkeypatch.setenv("MODELWEIGHTS", str(tmp_path / "run" / name))
            monkeypatch.setenv("PRED_FILE", name + ".zarr")
            dockerscript.main()
            outs[name] = np.asarray(ZGroup.open(
                tmp_path / (name + ".zarr"))["annotation"][:])
    else:
        make_survey_dir(tmp_path / "memm", year=2017, n_echograms=1, H=130,
                        W=260, seed=9)
        (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(dict(
            cfg, data_mode="memm", path_to_echograms=str(tmp_path / "memm"),
            partition_predict="selected surveys", evaluation_surveys=[2017],
            eval_mode="all")))
        for name in ("best.msgpack", "best.pt"):
            out = tmp_path / ("metrics_" + name.replace(".", "_"))
            evaluate.main(["--yaml_path", str(tmp_path / "cfg.yaml"),
                           "--checkpoint_path", str(tmp_path / "run" / name),
                           "--save_path_metrics", str(out),
                           "--save_path_plot", str(tmp_path / "plots"),
                           "--device", "cpu"])
            (csv_path,) = out.rglob("*_test.csv")
            outs[name] = csv_path.read_text()
    a, b = outs["best.msgpack"], outs["best.pt"]
    if entry == "docker":
        assert (a != 0).any()
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and len(a.splitlines()) > 2
