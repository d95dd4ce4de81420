"""AOT serving export of the port (crimac_unet_tpu_torch/pipeline/export.py)
against its own eager serving forward and against the JAX package's
artifact (crimac_unet_tpu/pipeline/export.py), on the CPU.

Every case of tests/test_export.py has its counterpart here, at the same
small size (depth 2, start_filts 4, patch 32, BatchNorm statistics
perturbed); the JAX variables reach the port through
``flax_to_torch_state_dict``.  The JAX test of a cross-platform lowering
becomes: an artifact exported on the CPU loads with ``device="cpu"``, and
without a device it needs a card.

Stated tolerances:
* the port's artifact against the port's eager serving forward: bit-equal
  (the same operators on the same inputs);
* against the JAX artifact on the same weights and numpy inputs, float32
  compute: probabilities within atol 1e-4 (the logit tolerance of
  tests/test_torch_model.py; float32 convolutions summed in another
  order); uint8 output codes identical except within that tolerance of a
  rounding boundary, where they are at most one code apart; bfloat16
  compute is held port-to-port only;
* the dB front end (gather_db over the batch as one slab) against the
  JAX transform: rtol 1e-6 / atol 1e-5 where log10 enters (last-ulp
  differences of the two log10s), bit-equal on uint8 codes.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.pipeline import export as jax_export
from crimac_unet_tpu.pipeline.engine import save_checkpoint
from crimac_unet_tpu.pipeline.infer_common import \
    _net_db_input as jax_net_db_input
from crimac_unet_tpu_torch.data.meta_channels import get_in_channels
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.ops.gather_db import gather_db
from crimac_unet_tpu_torch.ops.patches import make_grid_starts
from crimac_unet_tpu_torch.ops.stitch import stitch_patches
from crimac_unet_tpu_torch.pipeline.export import (export_checkpoint,
                                                   export_predictor,
                                                   export_slab_predictor,
                                                   load_predictor, main,
                                                   make_serving_forward,
                                                   save_exported)
from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

REPO = Path(__file__).resolve().parent.parent
CFG = {"patch_size": [32, 32], "frequencies": [18, 38, 120, 200],
       "depth": 2, "start_filts": 4, "compute_dtype": "bfloat16"}
META6 = {"portion_year": True, "portion_day": True, "time_diff": True,
         "depth_rel": True, "depth_abs_surface": True,
         "depth_abs_seabed": True}
M = get_in_channels(META6)
CPU = "cpu"


def _jax_variables(cfg, seed=0):
    """JAX model + numpy variables with perturbed BatchNorm statistics (as
    tests/test_export.py makes them)."""
    model = jax_build_unet(cfg)
    n_meta = get_in_channels(cfg.get("meta_channels"))
    late = bool(cfg.get("late_meta_inject"))
    x = jnp.zeros((1, 32, 32, 4 + (0 if late else n_meta)))
    kw = {"meta": jnp.zeros((1, 32, 32, n_meta))} if late else {}
    v = model.init(jax.random.PRNGKey(seed), x, train=False, **kw)
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), v)
    return model, v


@pytest.fixture(scope="module")
def weights():
    """(JAX model, JAX variables, port state dict) per config key."""
    cache = {}

    def get(key):
        if key not in cache:
            cfg = _config(key)
            model, v = _jax_variables(cfg)
            cache[key] = (model, v, flax_to_torch_state_dict(v))
        return cache[key]
    return get


def _config(key, compute="bfloat16"):
    cfg = dict(CFG, compute_dtype=compute)
    if key == "early":
        cfg.update(meta_channels=META6)
    elif key == "late":
        cfg.update(meta_channels=META6, late_meta_inject=True)
    return cfg


def _raw(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.lognormal(np.log(1e-6), 2.0, shape)
    x[0, :2, :2, 0] = np.nan                      # scrub path
    x[0, 2, 2, 1] = np.inf
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _export(sd, cfg, tmp_path, name="a.pt2", mode="patch", **kw):
    model = build_unet(cfg)
    ep = export_slab_predictor(model, sd, cfg, device=CPU) \
        if mode == "slab" else export_predictor(model, sd, cfg, device=CPU,
                                                **kw)
    path = tmp_path / name
    save_exported(ep, path)
    return ep, load_predictor(path, device=CPU)


def _live(sd, cfg):
    return make_serving_forward(build_unet(cfg), sd, cfg, device=CPU)


def _crimac_ops(ep):
    """crimac:: operators of an exported graph, its submodules walked."""
    return sorted(str(n.target) for m in ep.graph_module.modules()
                  if isinstance(m, torch.fx.GraphModule)
                  for n in m.graph.nodes
                  if str(n.target).startswith("crimac."))


def test_artifact_matches_live_forward(weights, tmp_path):
    _, _, sd = weights("plain")
    _, predict = _export(sd, CFG, tmp_path)
    x = _t(_raw((3, 32, 32, 4)))
    got = predict(x)
    assert got.shape == (3, 32, 32, 3) and got.dtype == torch.float32
    assert torch.equal(got, _live(sd, CFG)(x))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-3)


def test_symbolic_batch_serves_multiple_sizes(weights, tmp_path):
    _, _, sd = weights("plain")
    _, predict = _export(sd, CFG, tmp_path)
    live = _live(sd, CFG)
    for b in (1, 5):
        x = _t(_raw((b, 32, 32, 4), seed=b))
        out = predict(x)
        assert out.shape == (b, 32, 32, 3) and torch.isfinite(out).all()
        assert torch.equal(out, live(x))


def test_fixed_batch_rejects_other_sizes(weights, tmp_path):
    _, _, sd = weights("plain")
    _, predict = _export(sd, CFG, tmp_path, batch=2)
    assert predict(_t(_raw((2, 32, 32, 4)))).shape == (2, 32, 32, 3)
    with pytest.raises(Exception):
        predict(_t(_raw((3, 32, 32, 4))))


@pytest.mark.parametrize("late", [False, True])
def test_meta_artifact_matches_live_forward(weights, tmp_path, late):
    """Metadata models export as two-input artifacts (acoustic patches +
    float32 meta channels), early concat and late MLP alike."""
    key = "late" if late else "early"
    cfg = _config(key)
    _, _, sd = weights(key)
    _, predict = _export(sd, cfg, tmp_path)
    live = _live(sd, cfg)
    rng = np.random.RandomState(9)
    for b in (1, 3):
        x = _t(_raw((b, 32, 32, 4), seed=b))
        meta = _t(rng.standard_normal((b, 32, 32, M)).astype(np.float32))
        got = predict(x, meta)
        assert got.shape == (b, 32, 32, 3)
        assert torch.equal(got, live(x, meta))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-3)


def test_meta_config_errors_rejected(weights):
    _, _, sd = weights("plain")
    with pytest.raises(ValueError, match="meta_channels keys"):
        export_predictor(build_unet(CFG), sd,
                         dict(CFG, meta_channels={"portion_year": True}),
                         device=CPU)
    with pytest.raises(ValueError, match="zero metadata channels"):
        export_predictor(build_unet(CFG), sd,
                         dict(CFG, late_meta_inject=True), device=CPU)


def test_all_false_meta_dict_exports(weights, tmp_path):
    """An explicitly disabled meta_channels dict is a plain model."""
    _, _, sd = weights("plain")
    cfg = dict(CFG, meta_channels={k: False for k in META6})
    _, predict = _export(sd, cfg, tmp_path, batch=1)
    x = _t(_raw((1, 32, 32, 4)))
    assert torch.equal(predict(x), _live(sd, CFG)(x))


def _msgpack(v, path):
    save_checkpoint(path, {"params": v["params"],
                           "batch_stats": v["batch_stats"]})
    return path


def test_unknown_mode_rejected(weights, tmp_path):
    _, v, _ = weights("plain")
    with pytest.raises(ValueError, match="unknown export mode"):
        export_checkpoint(_msgpack(v, tmp_path / "c.msgpack"), CFG,
                          tmp_path / "o.pt2", device=CPU, mode="slabs")


def test_memm_config_export_warns(weights, tmp_path):
    _, v, _ = weights("plain")
    with pytest.warns(UserWarning, match="border_zero"):
        export_checkpoint(_msgpack(v, tmp_path / "c.msgpack"),
                          dict(CFG, data_mode="memm"), tmp_path / "o.pt2",
                          device=CPU)


@pytest.mark.parametrize("fold_bn", [True, False])
def test_missing_batch_stats_rejected(weights, fold_bn):
    _, _, sd = weights("plain")
    no_stats = {k: v for k, v in sd.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))}
    with pytest.raises(ValueError, match="running statistics"):
        make_serving_forward(build_unet(CFG), no_stats,
                             dict(CFG, fold_bn=fold_bn), device=CPU)


def test_save_exported_is_atomic(weights, tmp_path):
    _, _, sd = weights("plain")
    ep = export_predictor(build_unet(CFG), sd, CFG, device=CPU)
    path = tmp_path / "unet.pt2"
    save_exported(ep, path)
    first = path.read_bytes()
    save_exported(ep, path)
    assert path.read_bytes() == first
    assert not (tmp_path / "unet.pt2.tmp").exists()


def test_slab_alignment_follows_model_not_config(weights, tmp_path):
    """The slab artifact's alignment comes from model.depth (2 here), not
    from a config with no depth key (which would say 16)."""
    _, _, sd = weights("plain")
    cfg = {k: v for k, v in CFG.items() if k != "depth"}
    model = build_unet(CFG)
    path = tmp_path / "slab.pt2"
    save_exported(export_slab_predictor(model, sd, cfg, device=CPU), path)
    out = load_predictor(path, device=CPU)(
        torch.full((1, 30, 50, 4), 1e-5))
    assert out.shape == (1, 30, 50, 3)


def test_slab_mode_rejects_fixed_batch(weights, tmp_path):
    _, v, _ = weights("plain")
    with pytest.raises(ValueError, match="symbolic batch"):
        export_checkpoint(_msgpack(v, tmp_path / "c.msgpack"), CFG,
                          tmp_path / "x.pt2", batch=8, device=CPU,
                          mode="slab")


@pytest.mark.parametrize("kind", ["junk", "jax"])
def test_bad_header_rejected(weights, tmp_path, kind):
    """Arbitrary bytes and a JAX-package artifact (CRIMACX1) are refused
    by name, before any device is asked for."""
    p = tmp_path / "a.bin"
    if kind == "junk":
        p.write_bytes(b"not an artifact")
        match = "header"
    else:
        model, v, _ = weights("plain")
        jax_export.save_exported(
            jax_export.export_predictor(model, v, CFG, batch=1), p)
        match = "JAX-package artifact"
    with pytest.raises(ValueError, match=match):
        load_predictor(p, device=CPU)


@pytest.mark.parametrize("fmt", ["msgpack", "pt"])
def test_export_checkpoint_end_to_end(weights, tmp_path, fmt):
    """A JAX msgpack checkpoint or a reference .pt state dict -> artifact
    equal to the live forward on the same weights."""
    _, v, sd = weights("plain")
    if fmt == "msgpack":
        ckpt = _msgpack(v, tmp_path / "best.msgpack")
    else:
        ckpt = tmp_path / "best.pt"
        torch.save({k: _t(a) for k, a in sd.items()}, ckpt)
    out = tmp_path / "serve.pt2"
    export_checkpoint(ckpt, CFG, out, device=CPU)
    x = _t(_raw((2, 32, 32, 4)))
    assert torch.equal(load_predictor(out, device=CPU)(x),
                       _live(sd, CFG)(x))


def test_matches_gridded_runner_patch_forward(weights):
    """The artifact's semantics are the live runner's patch forward: the
    same windows of a chunk slab, in the runner's sub-batches, stitched,
    equal to ``GriddedRunner._predict_patches`` within atol 2e-7."""
    _, _, sd = weights("plain")
    cfg = dict(CFG, patch_overlap=4, fwd_batch=8, transfer_dtype="float32")
    runner = GriddedRunner(build_unet(cfg), sd, cfg, device=CPU)
    R, C, o = 3, 4, 4
    sh, sw = runner.stride
    slab = _raw((1, R * sh + 2 * o, C * sw + 2 * o, 4), seed=7)[0]
    y0s, x0s = make_grid_starts(R, C, sh, sw, o, o, o)
    y0p, x0p = runner.grid_starts(y0s, x0s)
    want = runner._predict_patches(_t(slab), y0p, x0p, len(y0s), None, R, C)
    ep = export_predictor(build_unet(cfg), sd, cfg, device=CPU)
    predict = ep.module()
    B, _, nb = runner._sub_batch_shape(len(y0s))
    windows = np.stack([slab[y:y + 32, x:x + 32]
                        for y, x in zip(y0p.numpy(), x0p.numpy())])
    with torch.no_grad():
        probs = torch.cat([predict(_t(windows[k * B:(k + 1) * B]))
                           for k in range(nb)])
    got = stitch_patches(probs[:len(y0s), ..., 1:3], R, C, o)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-7, rtol=0)


def test_slab_export_serves_arbitrary_aligned_chunks(weights, tmp_path):
    _, _, sd = weights("plain")
    _, predict = _export(sd, CFG, tmp_path, mode="slab")
    live = _live(sd, CFG)
    for shape in ((1, 64, 96), (2, 30, 50)):
        rng = np.random.RandomState(shape[-1])
        x = _t(rng.lognormal(np.log(1e-6), 2.0, shape + (4,)).astype(
            np.float32))
        got = predict(x)
        assert got.shape == shape + (3,)
        assert torch.equal(got, live(x))
    with pytest.raises(Exception):           # 33 is not a multiple of 2
        predict(torch.zeros((1, 33, 50, 4)))


def test_cli_writes_artifact(weights, tmp_path, capsys):
    _, v, _ = weights("plain")
    ckpt = _msgpack(v, tmp_path / "best.msgpack")
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(
        "patch_size: [32, 32]\nfrequencies: [18, 38, 120, 200]\n"
        "depth: 2\nstart_filts: 4\ncompute_dtype: bfloat16\n"
        "data_mode: zarr\n")
    out = tmp_path / "cli.pt2"
    main(["--yaml_path", str(cfg_yaml), "--checkpoint_path", str(ckpt),
          "--out", str(out), "--batch", "2", "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    got = load_predictor(out, device=CPU)(_t(_raw((2, 32, 32, 4))))
    assert got.shape == (2, 32, 32, 3) and torch.isfinite(got).all()
    out2 = tmp_path / "cli_slab.pt2"
    main(["--yaml_path", str(cfg_yaml), "--checkpoint_path", str(ckpt),
          "--out", str(out2), "--mode", "slab", "--device", "cpu"])
    got = load_predictor(out2, device=CPU)(torch.full((1, 40, 60, 4), 1e-5))
    assert got.shape == (1, 40, 60, 3) and torch.isfinite(got).all()


def test_cpu_export_loads_on_cpu_and_needs_a_card_by_default(
        weights, tmp_path, monkeypatch):
    """Traced on the CPU, loaded with device='cpu'; with no device the
    loader asks for cuda and raises without a card (no CPU fallback)."""
    _, _, sd = weights("plain")
    _, predict = _export(sd, CFG, tmp_path)
    out = predict(_t(_raw((2, 32, 32, 4))))
    assert out.shape == (2, 32, 32, 3) and torch.isfinite(out).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_predictor(tmp_path / "a.pt2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_predictor(build_unet(CFG), sd, CFG)


def test_uint8_artifact_matches_live_quantized_path(weights, tmp_path):
    """transfer_dtype: uint8 takes host-computed dB codes: bit-equal to
    the live forward on the codes, within the quantization envelope of
    the exact float32 artifact, and refuses float32 input."""
    _, _, sd = weights("plain")
    cfg8 = dict(CFG, transfer_dtype="uint8")
    _, predict = _export(sd, cfg8, tmp_path, name="u8.pt2")
    raw = _raw((3, 32, 32, 4))
    codes = _t(_quantize_db_u8(raw))
    assert codes.dtype == torch.uint8
    got = predict(codes)
    assert torch.equal(got, _live(sd, cfg8)(codes))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-3)
    with pytest.raises(Exception):
        predict(_t(raw))
    _, exact = _export(sd, CFG, tmp_path, name="f32.pt2")
    assert (got - exact(_t(raw))).abs().mean() < 0.02


def test_bfloat16_artifact_input_dtype(weights, tmp_path):
    """transfer_dtype: bfloat16 takes bf16 raw sv and equals the float32
    artifact fed the pre-cast inputs."""
    _, _, sd = weights("plain")
    _, predict = _export(sd, dict(CFG, transfer_dtype="bfloat16"), tmp_path,
                         name="bf16.pt2")
    xb = _t(_raw((2, 32, 32, 4))).to(torch.bfloat16)
    out = predict(xb)
    assert out.shape == (2, 32, 32, 3) and torch.isfinite(out).all()
    _, f32 = _export(sd, CFG, tmp_path, name="f32.pt2")
    assert torch.equal(out, f32(xb.float()))


def test_export_rejects_bad_transfer_dtype(weights):
    _, _, sd = weights("plain")
    with pytest.raises(ValueError, match="transfer_dtype"):
        export_predictor(build_unet(CFG), sd,
                         dict(CFG, transfer_dtype="int8"), device=CPU)


@pytest.mark.parametrize("bad", ["float32", "i8"])
def test_uint8_output_artifact(weights, tmp_path, bad):
    """output_dtype: uint8 returns round(p * 255) codes: bit-equal to the
    live forward and to the float32 artifact's probabilities coded; an
    output_dtype of float32 or an unknown name is refused."""
    _, _, sd = weights("plain")
    cfg = dict(CFG, output_dtype="uint8")
    _, predict = _export(sd, cfg, tmp_path, name="o8.pt2")
    raw = _t(_raw((2, 32, 32, 4)))
    got = predict(raw)
    assert got.dtype == torch.uint8 and got.shape == (2, 32, 32, 3)
    assert torch.equal(got, _live(sd, cfg)(raw))
    _, f32 = _export(sd, CFG, tmp_path, name="f32.pt2")
    assert torch.equal(got, torch.round(f32(raw) * 255).to(torch.uint8))
    np.testing.assert_allclose((got.float() / 255).sum(-1).numpy(), 1.0,
                               atol=2 / 255 + 1e-3)
    with pytest.raises(ValueError, match="output_dtype"):
        make_serving_forward(build_unet(CFG), sd,
                             dict(CFG, output_dtype=bad), device=CPU)


@pytest.mark.parametrize("mode,fold_bn,pool", [
    ("patch", True, "crimac.relu_pool_skip.default"),
    ("patch", False, "crimac.maxpool2x2.default"),
    ("slab", True, "crimac.relu_pool_skip.default"),
    ("slab", False, "crimac.maxpool2x2.default")])
def test_graph_holds_the_kernel_ops(weights, mode, fold_bn, pool):
    """The exported graph launches K1 and K3 once each (K2 with fold_bn:
    false), through the crimac:: operators, never their plain versions."""
    _, _, sd = weights("plain")
    cfg = dict(CFG, fold_bn=fold_bn)
    model = build_unet(cfg)
    ep = export_slab_predictor(model, sd, cfg, device=CPU) \
        if mode == "slab" else export_predictor(model, sd, cfg, device=CPU)
    assert _crimac_ops(ep) == sorted(["crimac.gather_db.default", pool])


def _jax_artifact(model, v, cfg, tmp_path, mode):
    exported = jax_export.export_slab_predictor(model, v, cfg) \
        if mode == "slab" else jax_export.export_predictor(model, v, cfg)
    path = tmp_path / "jax.stablehlo"
    jax_export.save_exported(exported, path)
    return jax_export.load_predictor(path)


def _inputs(transfer, raw):
    if transfer == "uint8":
        codes = _quantize_db_u8(raw)
        return codes, _t(codes)
    if transfer == "bfloat16":
        xb = raw.astype(ml_dtypes.bfloat16)
        return xb, _t(raw).to(torch.bfloat16)
    return raw, _t(raw)


@pytest.mark.parametrize("mode", ["patch", "slab"])
@pytest.mark.parametrize("key,transfer,output", [
    ("plain", "float32", "float16"), ("plain", "bfloat16", "float16"),
    ("plain", "uint8", "float16"), ("plain", "float32", "uint8"),
    ("plain", "uint8", "uint8"), ("early", "float32", "float16"),
    ("late", "float32", "float16")])
def test_artifact_matches_jax_artifact(weights, tmp_path, mode, key,
                                       transfer, output):
    """Float32 compute, the same weights and numpy inputs: the port's
    artifact against the JAX package's, probabilities within atol 1e-4,
    uint8 codes at most one apart and only next to a rounding boundary."""
    model32 = jax_build_unet(_config(key, "float32"))
    _, v, sd = weights(key)
    cfg = dict(_config(key, "float32"), transfer_dtype=transfer,
               output_dtype=output)
    shape = (3, 32, 32, 4) if mode == "patch" else (2, 48, 64, 4)
    x_np, x_t = _inputs(transfer, _raw(shape, seed=5))
    args_np, args_t = (x_np,), (x_t,)
    if key != "plain":
        meta = np.random.RandomState(2).standard_normal(
            shape[:3] + (M,)).astype(np.float32)
        args_np, args_t = (x_np, meta), (x_t, _t(meta))
    want = np.asarray(_jax_artifact(model32, v, cfg, tmp_path, mode)(
        *args_np))
    _, predict = _export(sd, cfg, tmp_path, mode=mode)
    got = predict(*args_t).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if output == "float16":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    # where the codes differ, the port's float32 probability lies within
    # 1e-4 of the boundary (code + 0.5) / 255 between them
    cfg_f = dict(cfg, output_dtype="float16")
    _, probs = _export(sd, cfg_f, tmp_path, name="p.pt2", mode=mode)
    p = probs(*args_t).numpy()[diff > 0]
    lo = np.minimum(got, want)[diff > 0].astype(np.float64)
    assert np.all(np.abs(p - (lo + 0.5) / 255) <= 1e-4)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("scaled", [False, True])
def test_front_end_matches_jax_transform(transfer, scaled):
    """gather_db over the batch viewed as one (B*H, W, C) slab (the
    artifact's front end) equals the JAX artifact's _net_db_input:
    rtol 1e-6 / atol 1e-5 on raw sv, bit-equal on uint8 codes."""
    raw = _raw((3, 32, 32, 4), seed=4)
    raw[1, 5, 5:9, 2] = -1e-3        # negative sv: NaN through log10
    x_np, x_t = _inputs(transfer, raw)
    B, H, W, C = x_t.shape
    starts = torch.arange(B, dtype=torch.int32) * H
    got = gather_db(x_t.reshape(B * H, W, C), starts,
                    torch.zeros_like(starts), (H, W), scaled=scaled)
    want = np.asarray(jax_net_db_input(jnp.asarray(x_np), use_meta=scaled))
    if transfer == "uint8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_loads_in_a_fresh_process(weights, tmp_path):
    """A process that imports only pipeline.export (not the model, not the
    ops) loads and serves a saved artifact on the CPU."""
    _, _, sd = weights("plain")
    _export(sd, CFG, tmp_path)
    x = _raw((2, 32, 32, 4))
    np.save(tmp_path / "x.npy", x)
    want = _live(sd, CFG)(_t(x)).numpy()
    code = f"""
import numpy as np, torch
from crimac_unet_tpu_torch.pipeline.export import load_predictor
out = load_predictor({str(tmp_path / 'a.pt2')!r}, device="cpu")(
    torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))
np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
print("SERVED", tuple(out.shape))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED (2, 32, 32, 3)" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
