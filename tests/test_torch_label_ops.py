"""The port's label sentinel algebra against the JAX package on the same
numpy inputs.  Stated tolerance: bit-equal (integer label algebra)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.ops import data_ops as jax_data_ops
from crimac_unet_tpu.ops import label_ops as jax_label_ops
from crimac_unet_tpu.pipeline.infer_common import \
    _convert_labels_host as jax_convert_labels_host
from crimac_unet_tpu_torch.constants import LABEL_BOUNDARY_VAL
from crimac_unet_tpu_torch.ops import data_ops, label_ops
from crimac_unet_tpu_torch.pipeline.infer_common import _convert_labels_host
from crimac_unet_tpu_torch.pipeline.runner import _float_to_int32

RAW_CODES = [0, 27, 1, 6, 6009, 5027, -1, -100, -50, -70, -30, -10]
B, H, W, C = 5, 24, 28, 4


def _raw_labels(rng):
    """Raw species codes, with a boundary band, one all-boundary patch
    and one patch that is boundary except a small block."""
    lab = rng.choice(RAW_CODES, size=(B, H, W),
                     p=[.4, .2, .1, .05, .05, .04, .04, .04, .02, .02, .02,
                        .02]).astype(np.int32)
    lab[1, :5, :] = LABEL_BOUNDARY_VAL
    lab[1, :, -3:] = LABEL_BOUNDARY_VAL
    lab[2] = LABEL_BOUNDARY_VAL               # the refine guard
    lab[3] = LABEL_BOUNDARY_VAL
    lab[3, 9:15, 4:12] = rng.choice([0, 27, 1], size=(6, 8))
    return lab


def _data(rng, channels_last):
    """Raw sv around the refine band (1e-7, 1e-4), edges included."""
    d = (10.0 ** rng.uniform(-9, -2, size=(B, H, W, C))).astype(np.float32)
    d[0, 3, :6, -1] = [1e-7, 1e-4, np.float32(1e-7), np.float32(1e-4),
                       np.nextafter(np.float32(1e-7), np.float32(1)),
                       np.nextafter(np.float32(1e-4), np.float32(0))]
    return d if channels_last else np.ascontiguousarray(
        d.transpose(0, 3, 1, 2))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(a):
    return np.asarray(a)


@pytest.mark.parametrize("mark_unused", [False, True])
def test_convert_label_indexing(mark_unused):
    lab = _raw_labels(np.random.RandomState(0))
    got = label_ops.convert_label_indexing(_t(lab), mark_unused).numpy()
    want = _j(jax_label_ops.convert_label_indexing(jnp.asarray(lab),
                                                   mark_unused))
    np.testing.assert_array_equal(got, want)


def test_valid_bbox_mask():
    rng = np.random.RandomState(1)
    valid = _raw_labels(rng) != LABEL_BOUNDARY_VAL
    valid[4] = False
    valid[4, 7, 20] = True                    # a one-pixel region
    got = label_ops._valid_bbox_mask(_t(valid)).numpy()
    want = _j(jax_label_ops._valid_bbox_mask(jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("given_mask", [False, True])
@pytest.mark.parametrize("seed", [2, 3])
def test_refine_label_boundary(channels_last, given_mask, seed):
    rng = np.random.RandomState(seed)
    lab = _j(jax_label_ops.convert_label_indexing(
        jnp.asarray(_raw_labels(rng)), mark_unused_species=True))
    data = _data(rng, channels_last)
    thr = rng.rand(B, H, W) < 0.6 if given_mask else None
    got = label_ops.refine_label_boundary(
        _t(data), _t(lab), channels_last=channels_last,
        threshold_mask=None if thr is None else _t(thr)).numpy()
    want = _j(jax_label_ops.refine_label_boundary(
        jnp.asarray(data), jnp.asarray(lab), channels_last=channels_last,
        threshold_mask=None if thr is None else jnp.asarray(thr)))
    np.testing.assert_array_equal(got, want)
    assert (got == -30).any()                 # the closing relabelled some
    np.testing.assert_array_equal(got[2], lab[2])   # all-boundary guard


def test_mask_label_seabed():
    rng = np.random.RandomState(4)
    lab = _j(jax_label_ops.convert_label_indexing(
        jnp.asarray(_raw_labels(rng)), mark_unused_species=True))
    sb = rng.randint(-5, H + 5, size=(B, W)).astype(np.int32)
    sb[0, ::3] = label_ops.BIG_ROW            # columns without a seabed
    sb[1] = label_ops.BIG_ROW
    got = label_ops.mask_label_seabed(_t(lab), _t(sb)).numpy()
    want = _j(jax_label_ops.mask_label_seabed(jnp.asarray(lab),
                                              jnp.asarray(sb)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("overlap", [0, 1, 4])
def test_mask_label_overlap(overlap):
    lab = _raw_labels(np.random.RandomState(5))
    got = label_ops.mask_label_overlap(_t(lab), overlap).numpy()
    want = _j(jax_label_ops.mask_label_overlap(jnp.asarray(lab), overlap))
    np.testing.assert_array_equal(got, want)


def test_set_label_ignore_val():
    lab = _raw_labels(np.random.RandomState(6))
    got = label_ops.set_label_ignore_val(_t(lab)).numpy()
    want = _j(jax_label_ops.set_label_ignore_val(jnp.asarray(lab)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels_last", [False, True])
def test_set_data_border_value(channels_last):
    rng = np.random.RandomState(7)
    lab = _raw_labels(rng)
    data = rng.randn(B, H, W, C).astype(np.float32)
    if not channels_last:
        data = np.ascontiguousarray(data.transpose(0, 3, 1, 2))
    got = data_ops.set_data_border_value(_t(data), _t(lab),
                                         channels_last=channels_last).numpy()
    want = _j(jax_data_ops.set_data_border_value(
        jnp.asarray(data), jnp.asarray(lab), channels_last=channels_last))
    np.testing.assert_array_equal(got, want)


def test_label_chain_of_float_labels():
    """Fractional, sentinel, NaN, infinite and out-of-range float codes:
    the float32-transfer cast (XLA's astype(int32)) and the host
    conversion of quantized-transfer eval, each against the JAX package."""
    rng = np.random.RandomState(8)
    raw = rng.choice([0.0, 27.0, 1.0, 6.0, 6009.0, -100.0, -50.0, 2.5,
                      27.5, 0.5, -0.5, 1.9, -0.99, np.nan, np.inf, -np.inf,
                      3e9, -3e9, 2147483520.0], size=(3, 40, 50)
                     ).astype(np.float32)
    got = _float_to_int32(_t(raw)).numpy()
    want = _j(jnp.asarray(raw).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)
    conv = label_ops.convert_label_indexing(_t(got), True).numpy()
    np.testing.assert_array_equal(conv, _j(jax_label_ops.convert_label_indexing(
        jnp.asarray(want), True)))
    host = _convert_labels_host(raw)
    assert host.dtype == np.int8
    np.testing.assert_array_equal(host, jax_convert_labels_host(raw))
    codes = _raw_labels(rng).astype(np.int16)   # an int16 label memmap
    np.testing.assert_array_equal(_convert_labels_host(codes),
                                  jax_convert_labels_host(codes))
