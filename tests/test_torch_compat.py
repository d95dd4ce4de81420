"""The port's reference-name layer: the JAX package's ``compat`` export
list, mapped onto the port's objects, and the ``.pt`` checkpoint names
(``load_torch_checkpoint``, ``save_torch_checkpoint``,
``torch_state_dict_to_flax``) through models/weights.py, bit-equal to the
JAX package's ``models/torch_import.py`` on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu import compat as jax_compat
from crimac_unet_tpu_torch import compat
from crimac_unet_tpu_torch.data.meta_channels import META_CHANNEL_KEYS


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_compat_exports_the_jax_list():
    missing = _public(jax_compat) - _public(compat)
    assert not missing, missing
    for name in ("Echogram", "DataReaderZarr", "get_data_readers",
                 "DataMemm", "DataZarr", "Background", "SchoolZarr",
                 "Gridded", "Dataset", "UNet_Baseline", "SegPipeUNet",
                 "save_survey_predictions_zarr", "refine_label_boundary",
                 "db_with_limits", "getGrid", "get_data_split",
                 "load_torch_checkpoint", "torch_state_dict_to_flax",
                 "save_torch_checkpoint", "get_data_grid_centers",
                 "CombineFunctions"):
        assert hasattr(compat, name), name
    # the port's objects, not the JAX package's
    for name in _public(compat):
        obj = getattr(compat, name)
        mod = getattr(obj, "__module__", None) or getattr(obj, "__name__",
                                                          "")
        assert not str(mod).startswith("crimac_unet_tpu."), (name, mod)
    assert issubclass(compat.UNet_Baseline, torch.nn.Module)


@pytest.mark.parametrize("mode", ["memm", "zarr"])
def test_get_data_readers(tmp_path, mode):
    from crimac_unet_tpu_torch.data import fixtures
    if mode == "memm":
        fixtures.make_survey_dir(tmp_path, year=2017, n_echograms=2, H=70,
                                 W=120, seed=3)
        readers = compat.get_data_readers([2017], mode="memm",
                                          path_to_echograms=str(tmp_path))
        want = jax_compat.get_data_readers([2017], mode="memm",
                                           path_to_echograms=str(tmp_path))
    else:
        fixtures.make_zarr_survey(tmp_path, year=2017, n_echograms=1, H=70,
                                  W=120, seed=3, layout="nested")
        readers = compat.get_data_readers([2017],
                                          path_to_zarr_files=str(tmp_path))
        want = jax_compat.get_data_readers([2017],
                                           path_to_zarr_files=str(tmp_path))
    assert [r.name for r in readers] == [r.name for r in want]
    assert len(readers) > 0


def _jax_variables(late_meta):
    from crimac_unet_tpu.models.unet import build_unet
    model = build_unet({"depth": 3, "start_filts": 8,
                        "late_meta_inject": late_meta})
    kw = {"meta": jnp.zeros((1, 32, 32, 2))} if late_meta else {}
    v = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 4)),
                   train=False, **kw)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(2)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("late_meta", [False, True])
def test_torch_checkpoint_names_match_jax(tmp_path, late_meta):
    from crimac_unet_tpu.models import torch_import as ti
    v = _jax_variables(late_meta)
    compat.save_torch_checkpoint(v, tmp_path / "port.pt")
    ti.save_torch_checkpoint(v, tmp_path / "jax.pt")
    a = torch.load(tmp_path / "port.pt", weights_only=True)
    b = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert sorted(a) == sorted(b)
    for k in b:
        # the JAX package writes each num_batches_tracked as shape (1,)
        # (np.ascontiguousarray of a 0-d array); the port as torch's own
        # BatchNorm2d state dict does, 0-d; torch loads either
        want = b[k].reshape(a[k].shape) if k.endswith(
            "num_batches_tracked") else b[k]
        assert a[k].dtype == want.dtype and torch.equal(a[k], want), k
    assert all(a[k].shape == () for k in a
               if k.endswith("num_batches_tracked"))
    back = compat.load_torch_checkpoint(tmp_path / "port.pt")
    want = ti.load_torch_checkpoint(tmp_path / "jax.pt")
    fa, fb = _flat(back), _flat(want)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(x, y, err_msg=str(k))
    # a round trip of the JAX variables, bit for bit
    for (k, x), (_, y) in zip(_flat(back), _flat(v)):
        np.testing.assert_array_equal(x, y, err_msg=str(k))
    sd = {k: t.numpy() for k, t in a.items()}
    for (k, x), (_, y) in zip(_flat(compat.torch_state_dict_to_flax(sd)),
                              _flat(ti.torch_state_dict_to_flax(sd))):
        np.testing.assert_array_equal(x, y, err_msg=str(k))
    # the exported state dict loads into the port's model (strict)
    compat.build_unet({"depth": 3, "start_filts": 8,
                       "late_meta_inject": late_meta,
                       "meta_channels": dict(
                           {k: False for k in META_CHANNEL_KEYS},
                           portion_day=True)     # 2 bands
                       if late_meta else {}}).load_state_dict(a)


def test_folded_params_are_rejected():
    v = _jax_variables(False)
    with pytest.raises(ValueError, match="batch_stats"):
        compat.save_torch_checkpoint({"params": v["params"]}, "unused.pt")
