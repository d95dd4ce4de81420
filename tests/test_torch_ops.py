"""The port's kernel modules (crimac_unet_tpu_torch.ops) against the JAX
package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode and against the JAX runner's
own XLA formulation.  Stated tolerances: gather_db within rtol 1e-6 /
atol 1e-5 of the float dB chain (log10 implementations differ in the last
ulp) and bit-equal on uint8 slabs; the pools, stitch, bit-unpack and
probability quantization bit-equal (NaN positions included).  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.ops import pallas_pool as PP
from crimac_unet_tpu.ops.pallas_gather import gather_db_pallas
from crimac_unet_tpu.ops.stitch import stitch_patches as jax_stitch
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.infer_common import (
    _net_db_input as jax_net_db_input, _quantize_db_u8 as jax_quantize_db_u8,
    _quantize_prob_u8 as jax_quantize_prob_u8, _unpack_bits as jax_unpack)
from crimac_unet_tpu_torch.ops.gather_db import gather_db
from crimac_unet_tpu_torch.ops.pool import maxpool2x2, relu_pool_skip
from crimac_unet_tpu_torch.ops.stitch import stitch_patches
from crimac_unet_tpu_torch.pipeline.infer_common import (_quantize_db_u8,
                                                         _quantize_prob_u8,
                                                         _unpack_bits)

RTOL, ATOL = 1e-6, 1e-5
CF, HP, WP, WIN = 4, 96, 128, (32, 32)


def _raw_slab(rng):
    slab = rng.lognormal(np.log(1e-6), 2.0, (HP, WP, CF)).astype(np.float32)
    slab[5:9, 10:20, 0] = np.nan
    slab[50:52, :, 2] = np.inf
    slab[60:62, 3:40, 1] = -np.inf
    slab[70, 70:90, 3] = -1e-3          # negative sv: NaN through log10
    return slab


def _starts(rng, n=13):
    y0s = rng.randint(0, HP - WIN[0] + 1, n).astype(np.int32)
    x0s = rng.randint(0, WP - WIN[1] + 1, n).astype(np.int32)
    return y0s, x0s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close_nan(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


@pytest.mark.parametrize("scaled", [False, True])
def test_gather_db_plain_matches_pallas(scaled):
    rng = np.random.RandomState(1)
    slab = _raw_slab(rng)
    y0s, x0s = _starts(rng)
    want = np.asarray(gather_db_pallas(
        jnp.asarray(slab.transpose(2, 0, 1)), jnp.asarray(y0s),
        jnp.asarray(x0s), WIN, scaled=scaled, interpret=True))
    got = gather_db(_t(slab), _t(y0s), _t(x0s), WIN, scaled=scaled).numpy()
    assert got.shape == (13, 32, 32, CF) and got.dtype == np.float32
    _assert_close_nan(got, want)


@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
def test_gather_db_plain_matches_pallas_narrow_window(cf, scaled):
    """Cf 1 and 3 with a 31-wide window at odd and even start columns:
    rows that start off the CUDA kernel's vector alignment."""
    rng = np.random.RandomState(10 + cf)
    slab = _raw_slab(rng)[:, :, :cf]
    win = (32, 31)
    y0s = rng.randint(0, HP - win[0] + 1, 8).astype(np.int32)
    x0s = np.array([0, 1, 2, 3, 33, 64, 95, WP - win[1]], np.int32)
    want = np.asarray(gather_db_pallas(
        jnp.asarray(slab.transpose(2, 0, 1)), jnp.asarray(y0s),
        jnp.asarray(x0s), win, scaled=scaled, interpret=True))
    got = gather_db(_t(slab), _t(y0s), _t(x0s), win, scaled=scaled).numpy()
    assert got.shape == (8, 32, 31, cf) and got.dtype == np.float32
    _assert_close_nan(got, want)


def _runner_formulation(slab, y0s, x0s, hp, border, scaled):
    """The JAX runner's front end (runner.py:329-358): zero-pad the
    shipped rows back to the grid height, dynamic_slice gather from the
    HWC slab, _net_db_input, then the border where."""
    wh, ww = WIN
    s = JaxRunner._pad_slab(jnp.asarray(slab), hp, slab.shape[1])

    def one(y0, x0):
        return jax.lax.dynamic_slice(s, (y0, x0, 0), (wh, ww, CF))
    d = jax_net_db_input(jax.vmap(one)(jnp.asarray(y0s), jnp.asarray(x0s)),
                         scaled)
    if border is not None:
        bm = JaxRunner._border_mask(jnp.asarray(border, jnp.int32), hp,
                                    slab.shape[1])

        def oneb(y0, x0):
            return jax.lax.dynamic_slice(bm, (y0, x0), (wh, ww))
        b = jax.vmap(oneb)(jnp.asarray(y0s), jnp.asarray(x0s))
        d = jnp.where(b[..., None], 0.0, d)
    return np.asarray(d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("border", [None, (9, 80, 6, 120)])
@pytest.mark.parametrize("scaled", [False, True])
def test_gather_db_plain_matches_runner(dtype, border, scaled):
    """Shipped slab cut to 70 of the grid's 96 rows: the rows below read
    as the zero pad, as in the runner's _pad_slab."""
    rng = np.random.RandomState(2)
    raw = _raw_slab(rng)[:70]
    if dtype == "uint8":
        slab_np = jax_quantize_db_u8(raw)
        np.testing.assert_array_equal(_quantize_db_u8(raw), slab_np)
        slab_t = _t(slab_np)
    elif dtype == "bfloat16":
        slab_t = _t(raw).to(torch.bfloat16)
        slab_np = slab_t.float().numpy().astype(jnp.bfloat16)
    else:
        slab_np, slab_t = raw, _t(raw)
    y0s, x0s = _starts(rng, n=16)
    want = _runner_formulation(slab_np, y0s, x0s, HP, border, scaled)
    got = gather_db(slab_t, _t(y0s), _t(x0s), WIN, border=border,
                    scaled=scaled).numpy()
    if dtype == "uint8":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_close_nan(got, want)
    # bfloat16 output: the float32 result cast once
    got16 = gather_db(slab_t, _t(y0s), _t(x0s), WIN, border=border,
                      scaled=scaled, out_dtype=torch.bfloat16)
    _assert_equal_nan(got16.float().numpy(), torch.from_numpy(got).to(
        torch.bfloat16).float().numpy())


def test_gather_db_checks():
    slab = torch.zeros(8, 8, 4)
    y, x = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gather_db(slab, y.long(), x, (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        gather_db(torch.zeros(8, 4, 8).transpose(1, 2), y, x, (4, 4))
    with pytest.raises(ValueError, match="dtype"):
        gather_db(slab.double(), y, x, (4, 4))
    with pytest.raises(ValueError, match="out_dtype"):
        gather_db(slab, y, x, (4, 4), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="length"):
        gather_db(slab, y[:1], x, (4, 4))
    # starts outside the slab read raw zeros (-75 dB), never out of bounds
    far = torch.tensor([-6, 20], dtype=torch.int32)
    out = gather_db(slab, far, far, (4, 4))
    assert torch.all(out == -75.0)


def _pool_input(kind, shape=(2, 16, 32, 64)):
    rng = np.random.RandomState(7)
    a = (rng.randn(*shape) * 2.0).astype(np.float32)
    if kind == "nan_inf":
        idx = rng.choice(a.size, 5, replace=False)
        a.flat[idx] = [np.nan, np.nan, np.inf, -np.inf, -np.nan]
    return a


def _assert_equal_nan(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_array_equal(got[m], want[m])


@pytest.mark.parametrize("kind", ["randn", "nan_inf"])
def test_maxpool_plain_bit_equal_pallas(kind):
    a = _pool_input(kind)
    want = PP.maxpool2x2(jnp.asarray(a, jnp.bfloat16), interpret=True)
    got = maxpool2x2(_t(a).to(torch.bfloat16))
    assert got.shape == (2, 8, 16, 64) and got.dtype == torch.bfloat16
    _assert_equal_nan(got.float().numpy(), want)


@pytest.mark.parametrize("kind", ["randn", "nan_inf"])
def test_relu_pool_skip_plain_bit_equal_pallas(kind):
    a = _pool_input(kind)
    wp, ws = PP.relu_pool_skip(jnp.asarray(a, jnp.bfloat16), interpret=True)
    gp, gs = relu_pool_skip(_t(a).to(torch.bfloat16))
    _assert_equal_nan(gp.float().numpy(), wp)
    _assert_equal_nan(gs.float().numpy(), ws)


@pytest.mark.parametrize("shape", [(3, 6, 10, 5), (1, 2, 2, 8)])
def test_pools_take_any_batch_and_channels(shape):
    """No 128-lane (B*C) constraint: odd B and C go through (compared with
    reduce_window, the XLA lowering the Pallas kernel is equal to)."""
    a = _pool_input("nan_inf", shape)
    x = _t(a).to(torch.bfloat16)
    want = PP.maxpool2x2_reference(jnp.asarray(a, jnp.bfloat16))
    _assert_equal_nan(maxpool2x2(x).float().numpy(), want)
    p, s = relu_pool_skip(x)
    _assert_equal_nan(p.float().numpy(), PP.maxpool2x2_reference(
        jax.nn.relu(jnp.asarray(a, jnp.bfloat16))))


def test_pool_checks():
    with pytest.raises(ValueError, match="even"):
        maxpool2x2(torch.zeros(1, 5, 4, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="even"):
        relu_pool_skip(torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError, match="contiguous"):
        maxpool2x2(torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)[:, :, :, :2]
                   .transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        maxpool2x2(torch.zeros(1, 4, 4, 8, dtype=torch.float16))


def test_stitch_bit_equal():
    rng = np.random.RandomState(3)
    R, C, o = 3, 4, 8
    p = rng.rand(R * C, 64, 64, 2).astype(np.float32)
    want = np.asarray(jax_stitch(jnp.asarray(p), R, C, o))
    got = stitch_patches(_t(p), R, C, o).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 63, 64, 65])
def test_unpack_bits_bit_equal(width):
    mask = np.random.RandomState(width).rand(5, width) > 0.5
    packed = np.packbits(mask, axis=1)
    got = _unpack_bits(_t(packed), width).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_unpack(jnp.asarray(packed), width)))
    np.testing.assert_array_equal(got, mask)


def test_quantize_prob_u8_bit_equal():
    p = np.random.RandomState(5).rand(4, 333).astype(np.float32)
    p[0, :4] = [0.0, 1.0, 0.5 / 255, 1.5 / 255]   # round-half-even ties
    got = _quantize_prob_u8(_t(p)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_quantize_prob_u8(jnp.asarray(p))))
