"""Metadata-channel training: the port against the JAX package, on the CPU.

The same synthetic memmap survey (one copy per package) feeds both
packages' pools and host crops; the same numpy batch and weights go
through both packages' train and eval steps, early and late inject, the
six channel families of ``config_meta_train.yaml``.  Stated tolerances:
- ``gather_meta_crops`` against the JAX ``_gather_meta_crops`` on the same
  vectors and against the host ``crop_meta``: rtol 1e-5, atol 1e-6, with
  Inf and NaN in the same places (a zero seabed divides to Inf or NaN);
  the pools' metadata vectors equal;
- ``augment_train_meta`` with the JAX package's draws injected: equal;
- one and two float32 train steps: loss within 1e-5 relative, each
  update within 1e-3 relative in max-norm of the JAX step run in float64
  (the test_torch_train_step.py law), BatchNorm statistics within 1e-5;
  the eval step's loss within 1e-5 and the histogram as there; the pooled
  steps equal the host-crop steps given the same crops exactly;
- late- and early-inject checkpoints written by either package restore in
  the other with every tensor equal (``meta_mlp`` and the widened first
  conv included), and resume to the same next step as the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from crimac_unet_tpu.data import device_pool as jax_pool
from crimac_unet_tpu.data.fixtures import make_survey_dir as jax_make_survey
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import augment as jax_augment
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu.pipeline.segpipe import SegPipeUNet as JaxSegPipe
from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
from crimac_unet_tpu_torch.data import device_pool
from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.meta_channels import crop_meta
from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
from crimac_unet_tpu_torch.models.weights import (flax_params_to_torch,
                                                  torch_to_flax_variables)
from crimac_unet_tpu_torch.ops import augment, metrics
from crimac_unet_tpu_torch.pipeline import engine
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
from test_torch_train_step import (_batch, _check_stats, _check_updates,
                                   _jax_params, _rel)

B, H, W, M = 4, 64, 64, 7
WIN = (H, W)
FREQS = [18, 38, 120, 200]
CFG = {"patch_size": [H, W], "depth": 3, "start_filts": 8,
       "frequencies": FREQS, "lr": 0.005, "lr_reduction": 0.5,
       "lr_step": 1000, "momentum": 0.95, "loss_type": "CE",
       "class_weights": [10.0, 300.0, 250.0], "random_seed": 10,
       "meta_channels": META_CHANNELS_ALL}
INJECT = [False, True]


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """(port readers, JAX readers): two 2017 echograms and one short one
    (48 range rows, shorter than the window: the recentering)."""
    out = []
    for make, cls in ((make_survey_dir, Echogram),
                      (jax_make_survey, JaxEchogram)):
        root = tmp_path_factory.mktemp("meta_train")
        make(root / "a", year=2017, n_echograms=2, H=150, W=300, seed=61,
             n_schools=4)
        make(root / "b", year=2017, n_echograms=1, H=48, W=200, seed=62,
             n_schools=2)
        out.append([cls(p) for p in sorted((root / "a").iterdir())
                    + sorted((root / "b").iterdir())])
    return out


def _centers(readers, rng, n=6):
    out = []
    for k, r in enumerate(readers):
        h, w = r.shape
        out += [(k, (0, 0)), (k, (h - 1, w + 20)), (k, (-30, -50))]
        out += [(k, (int(rng.randint(-40, h + 40)),
                     int(rng.randint(-40, w + 40)))) for _ in range(n)]
    return out


def _assert_meta_close(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gather_meta_crops_match_jax_and_host(surveys):
    port, jax_r = surveys
    pool = device_pool.DeviceSamplePool(port, FREQS, WIN, "cpu",
                                        meta_channels=META_CHANNELS_ALL)
    jpool = jax_pool.DeviceSamplePool(jax_r, FREQS, WIN,
                                      meta_channels=META_CHANNELS_ALL)
    assert pool.meta_flags == jpool.meta_flags == device_pool.META_ORDER
    for v, jv in zip(pool.meta_vectors, jpool.meta_vectors):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    samples = _centers(port, np.random.RandomState(1))
    idx, starts = pool.prepare_batch([(port[k], c) for k, c in samples])
    got = device_pool.gather_meta_crops(
        *pool.meta_vectors, torch.from_numpy(idx), torch.from_numpy(starts),
        WIN, pool.meta_flags).numpy()
    want = np.asarray(jax_pool._gather_meta_crops(
        *jpool.meta_vectors, jnp.asarray(idx), jnp.asarray(starts), WIN,
        jpool.meta_flags))
    assert got.shape == (len(samples), M, H, W) and got.dtype == np.float32
    _assert_meta_close(got, want)
    for b, (k, c) in enumerate(samples):
        _assert_meta_close(got[b], crop_meta(port[k], c, WIN,
                                             META_CHANNELS_ALL))


@pytest.mark.parametrize("family", device_pool.META_ORDER)
def test_gather_meta_crops_zero_seabed_and_each_family(family):
    """Random vectors with zero seabed rows: Inf and NaN where XLA puts
    them; each family alone."""
    rng = np.random.RandomState(7)
    E, Wv = 3, 90
    pod = rng.rand(E, Wv).astype(np.float32)
    tdiff = rng.rand(E, Wv).astype(np.float32)
    seabed = rng.randint(0, 60, (E, Wv)).astype(np.float32)
    seabed[:, ::7] = 0.0
    pyear = rng.rand(E).astype(np.float32)
    npings = np.array([90, 70, 40], np.int32)
    idx = rng.randint(0, E, 12).astype(np.int32)
    starts = np.stack([rng.randint(-10, 120, 12),
                       rng.randint(-10, 150, 12)], axis=1).astype(np.int32)
    win = (32, 32)
    vec = (pod, tdiff, seabed, pyear, npings)
    for flags in ((family,), device_pool.META_ORDER):
        got = device_pool.gather_meta_crops(
            *map(torch.from_numpy, vec), torch.from_numpy(idx),
            torch.from_numpy(starts), win, flags).numpy()
        want = np.asarray(jax_pool._gather_meta_crops(
            *map(jnp.asarray, vec), jnp.asarray(idx), jnp.asarray(starts),
            win, flags))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        _assert_meta_close(got, want)
    if family == "depth_rel":
        assert np.isinf(got).any() and np.isnan(got).any()


def _meta(seed):
    rng = np.random.RandomState(seed)
    meta = rng.uniform(-1, 1, (B, M, H, W)).astype(np.float32)
    meta[:, 4] = np.linspace(0, 2, H, dtype=np.float32)[None, :, None]
    return meta


def test_augment_train_meta_equals_jax_with_injected_draws(monkeypatch):
    data, labels, _ = _batch(13)
    meta = _meta(13)
    key = jax.random.PRNGKey(21)
    want = jax_augment.augment_train_meta(key, jnp.asarray(data),
                                          jnp.asarray(meta),
                                          jnp.asarray(labels))
    # the JAX package's own draws (augment.py: split, then split 5 ways)
    k_noise, k_flip = jax.random.split(key)
    ka, kc, ki, ku, kd = jax.random.split(k_noise, 5)
    shape = data.shape
    noise = tuple(torch.from_numpy(np.array(x)) for x in (
        jax.random.bernoulli(ka, 0.5, (B,)),
        jax.random.bernoulli(kc, 0.05, shape),
        jax.random.bernoulli(ki, 0.5, shape),
        jax.random.uniform(ku, shape, minval=1.0, maxval=10.0),
        jax.random.uniform(kd, shape, minval=0.0, maxval=1.0)))
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5,
                                                          (B,))))
    assert 0 < int(flip.sum()) < B
    monkeypatch.setattr(augment, "draw_noise", lambda g, s, d: noise)
    monkeypatch.setattr(augment, "draw_flip", lambda g, b, d: flip)
    got = augment.augment_train_meta(None, torch.from_numpy(data),
                                     torch.from_numpy(meta),
                                     torch.from_numpy(labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def identity_augment_meta(monkeypatch):
    monkeypatch.setattr(jax_augment, "augment_train_meta",
                        lambda key, d, m, lab: (d, m, lab))
    monkeypatch.setattr(augment, "augment_train_meta",
                        lambda gen, d, m, lab: (d, m, lab))


def _cfg(late):
    return dict(CFG, late_meta_inject=late, compute_dtype="float32",
                train_dtype="float32")


def _jax64(cfg, net):
    cfg64 = dict(cfg, compute_dtype="float64", train_dtype="float64")
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               torch_to_flax_variables(net.state_dict()))
    jmodel = jax_build_unet(cfg64)
    return jmodel, cfg64, jax_engine.init_train_state(
        jmodel, cfg64, jax.random.PRNGKey(0), variables=v)


@pytest.mark.parametrize("late", INJECT)
def test_meta_train_steps_match_jax_float64(identity_augment_meta, late):
    cfg = _cfg(late)
    net = init_train_(build_unet(cfg), torch.Generator().manual_seed(3))
    if late:
        assert net.late_meta_inject and \
            net.down_convs[0].main[0].in_channels == 4
    else:
        assert net.down_convs[0].main[0].in_channels == 4 + M
    state = engine.init_train_state(net, cfg)
    step = engine.make_train_step(cfg)
    with jax.enable_x64(True):
        jmodel, cfg64, jstate = _jax64(cfg, net)
        jstep = jax_engine.make_train_step(jmodel, cfg64)
    for k in range(2):
        data, labels, _ = _batch(20 + k)
        meta = _meta(20 + k)
        p0 = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
        loss = step(state, torch.from_numpy(data), torch.from_numpy(labels),
                    None, meta=torch.from_numpy(meta))
        with jax.enable_x64(True):
            jp0 = _jax_params(jstate, np.float64)
            jstate, jloss = jstep(jstate, jnp.asarray(data),
                                  jnp.asarray(labels), jnp.asarray(meta),
                                  jax.random.PRNGKey(k))
            jp1 = _jax_params(jstate, np.float64)
        assert _rel(loss, jloss) <= 1e-5
        _check_updates(net, p0, jp1, jp0, 1e-3)
        _check_stats(net, jstate, 1e-5)
    assert state.step == int(jstate.step) == 2


@pytest.mark.parametrize("late", INJECT)
def test_meta_eval_step_matches_jax(late):
    cfg = _cfg(late)
    net = init_train_(build_unet(cfg), torch.Generator().manual_seed(4))
    jmodel = jax_build_unet(cfg)
    v = jax.tree_util.tree_map(jnp.asarray,
                               torch_to_flax_variables(net.state_dict()))
    data, labels, seabed = _batch(5)
    meta = _meta(5)
    hist, loss = engine.make_eval_step(cfg)(
        net, metrics.new_histogram(), torch.from_numpy(data),
        torch.from_numpy(labels), torch.from_numpy(seabed),
        meta=torch.from_numpy(meta))
    jhist, jloss = jax_engine.make_eval_step(jmodel, cfg)(
        v["params"], v["batch_stats"], jax_metrics.new_histogram(),
        jnp.asarray(data), jnp.asarray(labels), jnp.asarray(seabed),
        jnp.asarray(meta))
    h, jh = hist.numpy().astype(np.int64), np.asarray(jhist, np.int64)
    np.testing.assert_array_equal(h.sum(axis=1), jh.sum(axis=1))
    assert np.abs(np.cumsum(h - jh, axis=1)).max() <= 1e-3 * h.sum()
    assert _rel(loss, jloss) <= 1e-5


@pytest.mark.parametrize("late", INJECT)
def test_pooled_meta_steps_equal_host_crop_steps(surveys,
                                                 identity_augment_meta,
                                                 late):
    """The pooled steps gather data, labels and metadata on the device;
    given the same crops the host-crop steps give the same result."""
    cfg = _cfg(late)
    port, _ = surveys
    pool = device_pool.DeviceSamplePool(port, FREQS, WIN, "cpu",
                                        meta_channels=META_CHANNELS_ALL)
    samples = _centers(port, np.random.RandomState(2), n=1)[:B]
    idx, starts = (torch.from_numpy(a) for a in pool.prepare_batch(
        [(port[k], c) for k, c in samples]))
    data, labels = device_pool.gather_crops(pool.data, pool.labels, idx,
                                            starts, WIN)
    meta = device_pool.gather_meta_crops(*pool.meta_vectors, idx, starts,
                                         WIN, pool.meta_flags)
    nets = [init_train_(build_unet(cfg), torch.Generator().manual_seed(6))
            for _ in range(2)]
    s1, s2 = (engine.init_train_state(n, cfg) for n in nets)
    l1 = engine.make_train_step(cfg)(s1, data, labels, None, meta=meta)
    l2 = engine.make_train_step_pooled(cfg)(
        s2, pool.data, pool.labels, idx, starts, None,
        meta_vectors=pool.meta_vectors, flags=pool.meta_flags)
    assert torch.equal(l1, l2)
    for (n, p), q in zip(nets[0].named_parameters(), nets[1].parameters()):
        assert torch.equal(p, q), n
    seabed = torch.full((B, W), 10 ** 6, dtype=torch.int32)
    h1, e1 = engine.make_eval_step(cfg)(nets[0], metrics.new_histogram(),
                                        data, labels, seabed, meta=meta)
    h2, e2 = engine.make_eval_step_pooled(cfg)(
        nets[1], metrics.new_histogram(), pool.data, pool.labels, idx,
        starts, seabed, meta_vectors=pool.meta_vectors,
        flags=pool.meta_flags)
    assert torch.equal(h1, h2) and torch.equal(e1, e2)


def test_segpipe_checks_pool_meta(surveys):
    port, _ = surveys
    plain = device_pool.DeviceSamplePool(port[:1], FREQS, WIN, "cpu")
    meta = device_pool.DeviceSamplePool(port[:1], FREQS, WIN, "cpu",
                                        meta_channels=META_CHANNELS_ALL)
    fewer = device_pool.DeviceSamplePool(
        port[:1], FREQS, WIN, "cpu",
        meta_channels=dict(META_CHANNELS_ALL, time_diff=False))
    sp = SegPipeUNet(dict(_cfg(False), device="cpu"))
    with pytest.raises(ValueError, match="built without them"):
        sp.attach_pool(plain)
    with pytest.raises(ValueError, match="mismatch"):
        sp.attach_pool_val(fewer)
    sp.attach_pool(meta).attach_pool_val(meta)
    sp0 = SegPipeUNet(dict(_cfg(False), meta_channels=None, device="cpu"))
    with pytest.raises(ValueError, match="does not enable them"):
        sp0.attach_pool(meta)


def _train(sp, steps, seed):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        data = rng.lognormal(np.log(3e-6), 1.5, (2, 4, H, W)).astype(
            np.float32)
        labels = np.zeros((2, H, W), np.int32)
        labels[:, 10:30, 10:40] = 27
        labels[:, 40:50, 5:20] = 1
        sp.train_step({"data": torch.from_numpy(data),
                       "labels": torch.from_numpy(labels),
                       "meta": torch.from_numpy(_meta(seed)[:2])})


@pytest.mark.parametrize("late", INJECT)
def test_meta_checkpoints_round_trip_both_ways(tmp_path, monkeypatch, late):
    monkeypatch.setattr(jax_augment, "augment_train_meta",
                        lambda key, d, m, lab: (d, m, lab))
    monkeypatch.setattr(augment, "augment_train_meta",
                        lambda gen, d, m, lab: (d, m, lab))
    cfg = dict(_cfg(late), device="cpu", mesh_devices=1, batch_size=2,
               log_step=100, depth=2, start_filts=4)
    # port -> JAX
    sp = SegPipeUNet(cfg)
    sp.init_model()
    sp.generator = torch.Generator().manual_seed(0)
    _train(sp, 2, 9)
    path = tmp_path / "port_last.msgpack"
    engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.25})
    want = engine.checkpoint_payload(sp.state)
    names = set(want["params"])
    assert ("meta_mlp" in names) == late
    assert want["params"]["down0"]["unit1"]["conv"]["kernel"].shape[2] == \
        (4 if late else 4 + M)
    jsp = JaxSegPipe(dict(cfg, device=None))
    jstate = jsp.resume_from(path)
    assert int(jstate.step) == 2 and jsp.best_F1_val == 0.25
    for got, ref in zip(
            jax.tree_util.tree_leaves(jax.device_get(
                {"p": jstate.params, "b": jstate.batch_stats,
                 "t": jstate.opt_state[0].trace})),
            jax.tree_util.tree_leaves(
                {"p": want["params"], "b": want["batch_stats"],
                 "t": want["opt_state"]["0"]["trace"]})):
        np.testing.assert_array_equal(np.asarray(got), ref)

    # JAX -> port: the JAX package steps once more and saves; the port
    # resumes from its file and takes the same next step
    jstep = jax_engine.make_train_step(jsp.model, cfg)
    data, labels, _ = _batch(30)
    data, labels = data[:2], labels[:2]
    meta = _meta(30)[:2]
    jstate, _ = jstep(jstate, jnp.asarray(data), jnp.asarray(labels),
                      jnp.asarray(meta), jax.random.PRNGKey(0))
    jpath = tmp_path / "jax_last.msgpack"
    jax_engine.save_checkpoint(jpath, jstate, extras={"best_f1": 0.5})
    rs = SegPipeUNet(cfg)
    rs.resume_from(jpath)
    assert rs.state.step == 3 and rs.best_F1_val == 0.5
    p0 = flax_params_to_torch(jax.tree_util.tree_map(np.array,
                                                     jstate.params))
    for name, p in rs.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), p0[name])
    with open(jpath, "rb") as f:
        jtree = serialization.msgpack_restore(f.read())
    port_tree = engine.checkpoint_payload(rs.state)
    for got, ref in zip(jax.tree_util.tree_leaves(port_tree),
                        jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(got, ref)
    data, labels, _ = _batch(31)
    data, labels, meta = data[:2], labels[:2], _meta(31)[:2]
    jstate, jloss = jstep(jstate, jnp.asarray(data), jnp.asarray(labels),
                          jnp.asarray(meta), jax.random.PRNGKey(1))
    rs.generator = torch.Generator().manual_seed(0)
    loss = rs.train_step({"data": torch.from_numpy(data),
                          "labels": torch.from_numpy(labels),
                          "meta": torch.from_numpy(meta)})
    assert _rel(loss, jloss) <= 1e-5
    assert rs.state.step == int(jstate.step) == 4
