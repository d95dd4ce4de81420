"""The port's train and eval steps against the JAX package's, on the CPU.

The same numpy batch (raw sv with NaN, boundary, unused-species and both
target classes) and the same weights (the port's torch-default
initialisation, mapped into the JAX package's layout) go through
``crimac_unet_tpu.pipeline.engine`` and ``crimac_unet_tpu_torch.pipeline.
engine``.  Augmentation draws differ by design, so the step tests replace
both packages' ``augment_train`` by the identity (before the JAX step is
first traced; nothing in the JAX package changes), and the augmentation's
apply step is tested with the JAX package's own draws injected.

Stated tolerances:
- losses (all four, incl. all-ignored batches) within 1e-6 relative, the
  LR schedule equal, the train and test label chains and the
  augmentation's apply step bit-equal;
- one and two SGD steps in float32: loss within 1e-5 relative, each
  parameter's update within 1e-3 relative in max-norm of the JAX step run
  in float64 (5e-2 of its float32 step, see the test), plus one float32
  ulp of the parameter (float32 weights quantize an update), BatchNorm running
  statistics within 1e-5 (1e-3 of the float32 step); a conv bias ahead of a BatchNorm (zero gradient
  in exact arithmetic) is held against its conv weight's update;
- one bfloat16 step: loss within 1e-2 relative; each update no further
  from the JAX float64 step's than twice the JAX bfloat16 step's own
  distance, plus 5e-2 relative in max-norm (see the test);
- the eval step: loss within 1e-5 relative; the histogram update bit-equal
  from the same probabilities, and from each package's own forward the
  same pixels per class with at most 0.1 % of them one float16 bin
  apart (float32 convolutions summed in another order move a
  probability by an ulp, which can cross a float16 rounding boundary);
  the pooled steps equal the host-crop steps exactly.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import augment as jax_augment
from crimac_unet_tpu.ops import data_ops as jax_data_ops
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu_torch.data.device_pool import gather_crops
from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
from crimac_unet_tpu_torch.models.weights import (flax_params_to_torch,
                                                  torch_to_flax_variables)
from crimac_unet_tpu_torch.ops import augment, metrics
from crimac_unet_tpu_torch.pipeline import engine

B, H, W = 4, 64, 64
CFG = {"patch_size": [H, W], "depth": 3, "start_filts": 8,
       "frequencies": [18, 38, 120, 200], "lr": 0.005, "lr_reduction": 0.5,
       "lr_step": 1000, "momentum": 0.95, "loss_type": "CE",
       "class_weights": [10.0, 300.0, 250.0], "random_seed": 10}


def _batch(seed):
    rng = np.random.RandomState(seed)
    data = rng.lognormal(np.log(3e-6), 1.5, (B, 4, H, W)).astype(np.float32)
    data[2, 0, 3:6, 3:6] = np.nan
    data[1, 3, 20:22, 30:40] = np.inf
    labels = np.zeros((B, H, W), np.int32)
    for b in range(B):
        y, x = rng.randint(5, 30, 2)
        labels[b, y:y + 20, x:x + 25] = 27
        y, x = rng.randint(30, 44, 2)
        labels[b, y:y + 15, x:x + 12] = 1
    labels[0, :, 56:] = -100
    labels[1, 5:9, 5:9] = 5
    labels[3, 50:, :] = -100
    seabed = rng.randint(40, 70, (B, W)).astype(np.int32)
    return data, labels, seabed


@pytest.fixture
def identity_augment(monkeypatch):
    monkeypatch.setattr(jax_augment, "augment_train",
                        lambda key, d, lab: (d, lab))
    monkeypatch.setattr(augment, "augment_train",
                        lambda gen, d, lab: (d, lab))


def _models(dtype, seed=0):
    cfg = dict(CFG, compute_dtype=dtype, train_dtype=dtype)
    net = init_train_(build_unet(cfg), torch.Generator().manual_seed(seed))
    v = jax.tree_util.tree_map(jnp.asarray,
                               torch_to_flax_variables(net.state_dict()))
    jmodel = jax_build_unet(cfg)
    jstate = jax_engine.init_train_state(jmodel, cfg, jax.random.PRNGKey(0),
                                         variables=v)
    return cfg, net, jmodel, jstate


def _jax_params(jstate, dtype=np.float32):
    """Reference-named copies (the JAX step donates its state)."""
    return flax_params_to_torch(jax.tree_util.tree_map(
        lambda a: np.array(a, dtype), jstate.params))


def _jax64(cfg, net):
    """The JAX package's model and fresh TrainState in float64, from the
    port's current weights (call under ``jax.enable_x64(True)``)."""
    cfg64 = dict(cfg, compute_dtype="float64", train_dtype="float64")
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               torch_to_flax_variables(net.state_dict()))
    jmodel = jax_build_unet(cfg64)
    return jmodel, jax_engine.init_train_state(
        jmodel, cfg64, jax.random.PRNGKey(0), variables=v)


# conv biases ahead of a BatchNorm: zero gradient in exact arithmetic, so
# their updates are held against the same conv's weight update
_BIAS_BEFORE_BN = re.compile(r"(main\.[03]|conv[12])\.bias$")


def _check_updates(net, p0, p1_ref, p0_ref, rtol):
    for name, p in net.named_parameters():
        up = p.detach().numpy() - p0[name]
        ref = p1_ref[name] - p0_ref[name]
        scale_name = name[:-4] + "weight" if _BIAS_BEFORE_BN.search(name) \
            else name
        scale = np.max(np.abs(p1_ref[scale_name] - p0_ref[scale_name]))
        # float32 parameters quantize an update to their own ulp
        ulp = np.max(np.spacing(np.abs(p0[name])))
        assert np.max(np.abs(up - ref)) <= rtol * scale + ulp, name


def _check_stats(net, jstate, rtol):
    stats = torch_to_flax_variables(net.state_dict())["batch_stats"]
    for got, want in zip(jax.tree_util.tree_leaves(stats),
                         jax.tree_util.tree_leaves(jstate.batch_stats)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-5)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("n_steps", [1, 2])
def test_sgd_steps_float32_match_jax(identity_augment, n_steps):
    """Against the JAX step in float64 (1e-3 on updates) and in float32:
    XLA's CPU float32 reductions accumulate in sequence, which moves the
    JAX package's own float32 updates by up to 2.4e-2 (relative, max-norm)
    and its running statistics by up to 3e-4 (relative) from its float64
    ones at this size, so float32 to float32 the updates are held to 5e-2
    and the statistics to 1e-3."""
    cfg, net, jmodel, jstate = _models("float32")
    jstep = jax_engine.make_train_step(jmodel, cfg)
    with jax.enable_x64(True):
        jmodel64, jstate64 = _jax64(cfg, net)
        jstep64 = jax_engine.make_train_step(jmodel64, dict(
            cfg, compute_dtype="float64"))
    state = engine.init_train_state(net, cfg)
    step = engine.make_train_step(cfg)
    for k in range(n_steps):
        data, labels, _ = _batch(k)
        p0 = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
        jp0 = _jax_params(jstate)
        loss = step(state, torch.from_numpy(data), torch.from_numpy(labels),
                    None)
        jstate, jloss = jstep(jstate, jnp.asarray(data), jnp.asarray(labels),
                              jax.random.PRNGKey(k))
        with jax.enable_x64(True):
            jp0_64 = _jax_params(jstate64, np.float64)
            jstate64, jloss64 = jstep64(jstate64, jnp.asarray(data),
                                        jnp.asarray(labels),
                                        jax.random.PRNGKey(k))
            jp1_64 = _jax_params(jstate64, np.float64)
        assert _rel(loss, jloss64) <= 1e-5 and _rel(loss, jloss) <= 1e-5
        _check_updates(net, p0, jp1_64, jp0_64, 1e-3)
        _check_updates(net, p0, _jax_params(jstate), jp0, 5e-2)
        _check_stats(net, jstate64, 1e-5)
        _check_stats(net, jstate, 1e-3)
    assert state.step == int(jstate.step) == int(jstate64.step) == n_steps


def test_sgd_step_bfloat16_matches_jax(identity_augment):
    """bfloat16 rounds at 2^-8 and the two backends round different
    intermediates, so near-zero gradients (a bias ahead of a BatchNorm or
    of a conv feeding one) are rounding noise in both.  Each parameter's
    bfloat16 update is held to the JAX package's float64 step no further
    than twice the JAX package's own bfloat16 update is, plus 5e-2 of its
    max-norm."""
    cfg, net, jmodel, jstate = _models("bfloat16")
    jstep = jax_engine.make_train_step(jmodel, cfg)
    with jax.enable_x64(True):
        jmodel64, jstate64 = _jax64(cfg, net)
        jp0_64 = _jax_params(jstate64, np.float64)
    state = engine.init_train_state(net, cfg)
    data, labels, _ = _batch(0)
    p0 = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    jp0 = _jax_params(jstate)
    loss = engine.make_train_step(cfg)(state, torch.from_numpy(data),
                                       torch.from_numpy(labels), None)
    jstate, jloss = jstep(jstate, jnp.asarray(data), jnp.asarray(labels),
                          jax.random.PRNGKey(0))
    with jax.enable_x64(True):
        jstate64, _ = jax_engine.make_train_step(jmodel64, dict(
            cfg, compute_dtype="float64"))(jstate64, jnp.asarray(data),
                                           jnp.asarray(labels),
                                           jax.random.PRNGKey(0))
        jp1_64 = _jax_params(jstate64, np.float64)
    assert _rel(loss, jloss) <= 1e-2
    jp1 = _jax_params(jstate)
    for name, p in net.named_parameters():
        truth = jp1_64[name] - jp0_64[name]
        err = np.max(np.abs(p.detach().numpy() - p0[name] - truth))
        jerr = np.max(np.abs(jp1[name] - jp0[name] - truth))
        assert err <= 2 * jerr + 5e-2 * np.max(np.abs(truth)) + \
            np.max(np.spacing(np.abs(p0[name]))), name


def test_pooled_train_step_equals_host_crop_step(identity_augment):
    """Crops gathered from a pool canvas give the host-crop step
    exactly."""
    cfg, net, _, _ = _models("float32")
    net2 = init_train_(build_unet(dict(cfg, compute_dtype="float32")),
                       torch.Generator().manual_seed(0))
    data, labels, _ = _batch(3)
    pad = 8
    canvas = torch.zeros((1, 4, H + 2 * pad, W * B + 2 * pad))
    lcanvas = torch.full((1, H + 2 * pad, W * B + 2 * pad), -100,
                         dtype=torch.int32)
    for b in range(B):
        canvas[0, :, pad:pad + H, pad + b * W:pad + (b + 1) * W] = \
            torch.from_numpy(np.nan_to_num(data[b], nan=0.0, posinf=0.0))
        lcanvas[0, pad:pad + H, pad + b * W:pad + (b + 1) * W] = \
            torch.from_numpy(labels[b])
    idx = torch.zeros(B, dtype=torch.int32)
    starts = torch.tensor([[pad, pad + b * W] for b in range(B)],
                          dtype=torch.int32)
    got_d, got_l = gather_crops(canvas, lcanvas, idx, starts, (H, W))
    s1, s2 = engine.init_train_state(net, cfg), engine.init_train_state(
        net2, cfg)
    l1 = engine.make_train_step(cfg)(s1, got_d, got_l, None)
    l2 = engine.make_train_step_pooled(cfg)(s2, canvas, lcanvas, idx, starts,
                                            None)
    assert torch.equal(l1, l2)
    for (n, p), q in zip(net.named_parameters(), net2.parameters()):
        assert torch.equal(p, q), n


def test_eval_step_matches_jax():
    cfg, net, jmodel, jstate = _models("float32", seed=4)
    data, labels, seabed = _batch(5)
    hist, loss = engine.make_eval_step(cfg)(
        net, metrics.new_histogram(), torch.from_numpy(data),
        torch.from_numpy(labels), torch.from_numpy(seabed))
    jhist, jloss = jax_engine.make_eval_step(jmodel, cfg)(
        jstate.params, jstate.batch_stats, jax_metrics.new_histogram(),
        jnp.asarray(data), jnp.asarray(labels), jnp.asarray(seabed))
    h, jh = hist.numpy().astype(np.int64), np.asarray(jhist, np.int64)
    np.testing.assert_array_equal(h.sum(axis=1), jh.sum(axis=1))
    assert np.abs(np.cumsum(h - jh, axis=1)).max() <= 1e-3 * h.sum()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    # from the same probabilities the histogram update is bit-equal
    probs = jax.nn.softmax(jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jax_data_ops.data_transform_test(
            jnp.asarray(data), jax_engine._test_labels(
                jnp.asarray(data), jnp.asarray(labels), jnp.asarray(seabed),
                0, -1))[0].transpose(0, 2, 3, 1), train=False), axis=-1)
    labels_t = jax_engine._test_labels(jnp.asarray(data), jnp.asarray(labels),
                                       jnp.asarray(seabed), 0, -1)
    np.testing.assert_array_equal(
        metrics.update_pr_histogram(
            metrics.new_histogram(), torch.from_numpy(np.asarray(
                probs[..., 1])), torch.from_numpy(np.asarray(
                    labels_t))).numpy(),
        np.asarray(jax_metrics.update_pr_histogram(
            jax_metrics.new_histogram(), probs[..., 1], labels_t)))
    # the pooled eval step over a canvas of the same crops
    canvas = torch.from_numpy(np.nan_to_num(data, nan=0.0, posinf=0.0))
    lab = torch.from_numpy(labels)
    idx = torch.arange(B, dtype=torch.int32)
    starts = torch.zeros((B, 2), dtype=torch.int32)
    hist2, loss2 = engine.make_eval_step_pooled(cfg)(
        net, metrics.new_histogram(), canvas, lab, idx, starts,
        torch.from_numpy(seabed))
    hist3, loss3 = engine.make_eval_step(cfg)(
        net, metrics.new_histogram(), canvas, lab, torch.from_numpy(seabed))
    assert torch.equal(hist2, hist3) and torch.equal(loss2, loss3)


@pytest.mark.parametrize("loss_type", ["CE", "Focal", "Dice", "Combined"])
@pytest.mark.parametrize("all_ignored", [False, True])
def test_losses_match_jax(loss_type, all_ignored):
    rng = np.random.RandomState(7)
    logits = (rng.randn(2, 16, 16, 3) * 3).astype(np.float32)
    labels = rng.choice([0, 1, 2, -100], (2, 16, 16)).astype(np.int32)
    if all_ignored:
        labels[:] = -100
    cfg = dict(CFG, loss_type=loss_type)
    got = float(engine.make_loss_fn(cfg)(torch.from_numpy(logits),
                                         torch.from_numpy(labels)))
    want = float(jax_engine.make_loss_fn(cfg)(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-6)


def test_lr_schedule_matches_optax():
    cfg = dict(CFG, lr=0.005, lr_step=1000, lr_reduction=0.5)
    ours = engine.make_lr_schedule(cfg)
    theirs = jax_engine.make_lr_schedule(cfg)
    for step in (0, 999, 1000, 2500):
        assert np.float32(ours(step)) == np.float32(theirs(step)), step


@pytest.mark.parametrize("chain", ["train", "test"])
def test_label_chains_bit_equal(chain):
    from crimac_unet_tpu_torch.pipeline.engine import (_test_labels,
                                                       _train_labels)
    data, labels, seabed = _batch(11)
    d, lab = torch.from_numpy(data), torch.from_numpy(labels)
    if chain == "train":
        got = _train_labels(d, lab, -1)
        want = jax_engine._train_labels(jnp.asarray(data),
                                        jnp.asarray(labels), -1)
    else:
        got = _test_labels(d, lab, torch.from_numpy(seabed), 4, -1)
        want = jax_engine._test_labels(jnp.asarray(data),
                                       jnp.asarray(labels),
                                       jnp.asarray(seabed), 4, -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) >= 4


def test_augmentation_apply_equals_jax_with_injected_draws():
    data, labels, _ = _batch(13)
    key = jax.random.PRNGKey(21)
    want_d, want_l = jax_augment.augment_train(key, jnp.asarray(data),
                                               jnp.asarray(labels))
    # the JAX package's own draws (augment.py: split, then split 5 ways)
    k_noise, k_flip = jax.random.split(key)
    ka, kc, ki, ku, kd = jax.random.split(k_noise, 5)
    shape = data.shape
    draws = [np.asarray(x) for x in (
        jax.random.bernoulli(ka, 0.5, (B,)),
        jax.random.bernoulli(kc, 0.05, shape),
        jax.random.bernoulli(ki, 0.5, shape),
        jax.random.uniform(ku, shape, minval=1.0, maxval=10.0),
        jax.random.uniform(kd, shape, minval=0.0, maxval=1.0))]
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,)))
    d = augment.add_noise(torch.from_numpy(data),
                          *[torch.from_numpy(x) for x in draws])
    got_d, got_l = augment.flip_x_axis(d, torch.from_numpy(labels),
                                       torch.from_numpy(flip))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_augmentation_draw_rates():
    """Loose statistical bounds on the port's own draws: p = 0.5 apply
    and flip rates, a 5 % pixel rate, factors in [1, 10) and [0, 1)."""
    gen = torch.Generator().manual_seed(3)
    apply, change, increase, up, down = augment.draw_noise(
        gen, (400, 2, 32, 32), "cpu")
    flips = augment.draw_flip(gen, 4000, "cpu")
    assert 0.4 < apply.float().mean() < 0.6
    assert 0.45 < flips.float().mean() < 0.55
    assert 0.045 < change.float().mean() < 0.055
    assert 0.49 < increase.float().mean() < 0.51
    assert float(up.min()) >= 1.0 and float(up.max()) < 10.0
    assert float(down.min()) >= 0.0 and float(down.max()) < 1.0
    data = torch.ones((400, 2, 32, 32))
    out = augment.add_noise(data, apply, change, increase, up, down)
    changed = (out != 1.0).float().mean(dim=(1, 2, 3))
    assert torch.all(changed[~apply] == 0)
    assert 0.04 < float(changed[apply].mean()) < 0.06
