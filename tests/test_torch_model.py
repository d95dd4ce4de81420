"""The port's U-Net (crimac_unet_tpu_torch.models) against the JAX UNet.

Random flax variables, with BatchNorm statistics drawn away from identity,
go through the port's weight converter into the torch UNet; logits are
compared with ``UNet.apply`` in float32 on the CPU, in BatchNorm form and
in folded form (the port's fold vs ``fold_for_serving``).  Tolerance:
atol 1e-4 on logits (float32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.models.fold_bn import fold_for_serving
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import UNet as JaxUNet
from crimac_unet_tpu.pipeline.engine import save_checkpoint
from crimac_unet_tpu_torch.models import weights
from crimac_unet_tpu_torch.models.fold_bn import (fold_for_serving as
                                                  torch_fold_for_serving,
                                                  fold_state_dict)
from crimac_unet_tpu_torch.models.unet import UNet, build_unet, init_random_

ATOL = 1e-4


def _flax_variables(depth, start_filts, seed, hw=32):
    model = JaxUNet(depth=depth, start_filts=start_filts)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed)

    def perturb(tree, lo, hi):
        return jax.tree_util.tree_map(
            lambda a: rng.uniform(lo, hi, a.shape).astype(np.float32), tree)
    stats = v["batch_stats"]
    for path_tree in jax.tree_util.tree_leaves(
            stats, is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
        path_tree["mean"] = rng.uniform(-0.2, 0.2, path_tree["mean"].shape
                                        ).astype(np.float32)
        path_tree["var"] = rng.uniform(0.5, 2.0, path_tree["var"].shape
                                       ).astype(np.float32)
    params = v["params"]

    def bn_affine(tree):
        for k, sub in tree.items():
            if k == "bn":
                sub["scale"] = perturb(sub["scale"], 0.5, 1.5)
                sub["bias"] = perturb(sub["bias"], -0.2, 0.2)
            elif isinstance(sub, dict):
                bn_affine(sub)
    bn_affine(params)
    return model, {"params": params, "batch_stats": stats}


def _torch_unet(depth, start_filts, state_dict, use_bn=True):
    m = UNet(depth=depth, start_filts=start_filts, use_bn=use_bn)
    m.load_state_dict(weights.to_tensors(state_dict))
    return m.eval()


def _input(seed, hw=32, b=2):
    return np.random.RandomState(seed).randn(b, hw, hw, 4).astype(
        np.float32) * 3.0


@pytest.mark.parametrize("depth,start_filts", [(2, 4), (3, 8)])
def test_logits_match_jax_bn_form(depth, start_filts):
    model, v = _flax_variables(depth, start_filts, seed=depth)
    x = _input(depth)
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    net = _torch_unet(depth, start_filts,
                      weights.flax_to_torch_state_dict(v))
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("depth,start_filts", [(2, 4), (3, 8)])
def test_logits_match_jax_folded_form(depth, start_filts):
    model, v = _flax_variables(depth, start_filts, seed=10 + depth)
    x = _input(10 + depth)
    fmodel, fv = fold_for_serving(model, v, {"fold_bn": True})
    want = np.asarray(fmodel.apply(fv, jnp.asarray(x), train=False))

    bn_net = UNet(depth=depth, start_filts=start_filts)
    sd = weights.to_tensors(weights.flax_to_torch_state_dict(v))
    net, fsd = torch_fold_for_serving(bn_net, sd, {"fold_bn": True})
    assert not net.use_bn
    assert not any("running_var" in k for k in fsd)
    net.load_state_dict(fsd)
    got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # unfolded policy keeps the BN model and its statistics
    same, sd2 = torch_fold_for_serving(bn_net, sd, {"fold_bn": False})
    assert same is bn_net and sd2 is sd


def test_pt_checkpoint_from_jax_package_loads(tmp_path):
    """A .pt written by the JAX package's save_torch_checkpoint loads into
    the port and gives the JAX logits."""
    model, v = _flax_variables(3, 4, seed=5)
    path = tmp_path / "model.pt"
    save_torch_checkpoint(v, path)
    sd = weights.load_checkpoint(path)
    net = _torch_unet(3, 4, sd)
    x = _input(5)
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=ATOL)
    # the JAX package's native msgpack checkpoint loads to the same
    # state dict (ROADMAP C1, closed)
    save_checkpoint(tmp_path / "model.msgpack", v)
    sd2 = weights.load_checkpoint(tmp_path / "model.msgpack")
    assert set(sd2) == set(sd)
    for k in sd:   # the .pt's num_batches_tracked is (1,), unread
        assert torch.equal(sd2[k].reshape(sd[k].shape), sd[k]), k


def test_fold_is_exact_on_weights():
    """The fold itself: folded weight/bias equal the float32 formula."""
    net = init_random_(UNet(depth=2, start_filts=4),
                       torch.Generator().manual_seed(0))
    sd = net.state_dict()
    fsd = fold_state_dict(sd)
    g = sd["down_convs.0.main.1.weight"] / torch.sqrt(
        sd["down_convs.0.main.1.running_var"] + 1e-5)
    want = sd["down_convs.0.main.0.weight"] * g.view(-1, 1, 1, 1)
    assert torch.equal(fsd["down_convs.0.main.0.weight"], want)
    assert set(fsd) == set(UNet(depth=2, start_filts=4,
                                use_bn=False).state_dict())


def test_seeded_init_and_build():
    cfg = {"depth": 3, "start_filts": 8, "compute_dtype": "float32",
           "frequencies": [18, 38, 120, 200]}
    a = init_random_(build_unet(cfg), torch.Generator().manual_seed(3))
    b = init_random_(build_unet(cfg), torch.Generator().manual_seed(3))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    with pytest.raises(ValueError, match="compute_dtype"):
        build_unet(dict(cfg, compute_dtype="float16"))
    # late inject needs metadata channels to feed its MLP
    with pytest.raises(ValueError, match="late_meta_inject"):
        build_unet(dict(cfg, late_meta_inject=True))
    # train mode runs with autograd; a BatchNorm-folded model is eval-only
    out = a.train()(torch.zeros(2, 16, 16, 4))
    assert out.shape == (2, 16, 16, 3) and out.requires_grad
    folded = UNet(depth=3, start_filts=8, use_bn=False)
    with pytest.raises(ValueError, match="eval-only"):
        folded.train()(torch.zeros(1, 16, 16, 4))
