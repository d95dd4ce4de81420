"""The port's 7x7-disc closing (K4's plain version and its CPU wrapper)
against scipy and the JAX package.  Stated tolerance: bit-equal (binary
morphology of 0/1 masks is exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from crimac_unet_tpu.ops import morphology as jax_morphology
from crimac_unet_tpu.ops.pallas_morphology import binary_closing_pallas
from crimac_unet_tpu_torch.ops import cuda_lib, morphology
from crimac_unet_tpu_torch.ops.closing import (binary_closing,
                                               binary_closing_reference)

DISC = morphology.DISC_7X7.astype(bool)


def _masks(rng, shape, density):
    return rng.rand(*shape) < density


@pytest.mark.parametrize("shape", [(4, 40, 48), (3, 5, 6), (2, 1, 9),
                                   (2, 13, 3), (1, 1, 1), (2, 7, 7)])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.75, 1.0])
def test_plain_closing_matches_scipy(shape, density):
    rng = np.random.RandomState(hash((shape, density)) % 2 ** 31)
    masks = _masks(rng, shape, density)
    got = morphology.binary_closing(torch.from_numpy(masks)).numpy()
    for i in range(shape[0]):
        want = ndi.binary_closing(masks[i], structure=DISC)
        np.testing.assert_array_equal(got[i], want, err_msg=f"mask {i}")
    np.testing.assert_array_equal(
        morphology.binary_dilation(torch.from_numpy(masks)).numpy(),
        np.stack([ndi.binary_dilation(m, structure=DISC) for m in masks]))
    np.testing.assert_array_equal(
        morphology.binary_erosion(torch.from_numpy(masks)).numpy(),
        np.stack([ndi.binary_erosion(m, structure=DISC) for m in masks]))


def _clip_boxes(B, H, W):
    """Full, inner, touching each edge, and empty clip boxes."""
    boxes = [(0, H, 0, W), (4, H - 4, 6, W - 2), (0, H // 2, 3, W - 3),
             (H // 3, H, 0, W), (2, H - 1, 0, W // 2), (1, H, W // 3, W),
             (0, 0, 0, 0)]
    clip = np.zeros((B, H, W), bool)
    for b in range(B):
        y0, y1, x0, x1 = boxes[b % len(boxes)]
        clip[b, y0:y1, x0:x1] = True
    return clip


@pytest.mark.parametrize("density", [0.3, 0.75])
def test_plain_closing_with_clip_matches_jax(density):
    rng = np.random.RandomState(5)
    B, H, W = 7, 32, 40
    clip = _clip_boxes(B, H, W)
    masks = _masks(rng, (B, H, W), density) & clip
    got = binary_closing_reference(torch.from_numpy(masks),
                                   torch.from_numpy(clip)).numpy()
    want_conv = np.asarray(jax_morphology.binary_closing(
        jnp.asarray(masks), clip_mask=jnp.asarray(clip)))
    want_pallas = np.asarray(binary_closing_pallas(
        jnp.asarray(masks), jnp.asarray(clip), interpret=True))
    np.testing.assert_array_equal(got, want_conv)
    np.testing.assert_array_equal(got, want_pallas)


def test_plain_closing_unclipped_mask_matches_jax():
    """Mask pixels outside the clip box: the clip cuts the dilation, not
    the mask (as the JAX conv path and the Pallas kernel do)."""
    rng = np.random.RandomState(6)
    B, H, W = 7, 24, 30
    clip = _clip_boxes(B, H, W)
    masks = _masks(rng, (B, H, W), 0.5)
    got = binary_closing_reference(torch.from_numpy(masks),
                                   torch.from_numpy(clip)).numpy()
    want = np.asarray(binary_closing_pallas(
        jnp.asarray(masks), jnp.asarray(clip), interpret=True))
    np.testing.assert_array_equal(got, want)


def _assert_closing_matches_jax(masks, clip):
    """binary_closing_reference bit-equal to the Pallas kernel (interpret
    mode) and to the JAX conv formulation."""
    got = binary_closing_reference(torch.from_numpy(masks),
                                   torch.from_numpy(clip)).numpy()
    m, c = jnp.asarray(masks), jnp.asarray(clip)
    np.testing.assert_array_equal(got, np.asarray(
        binary_closing_pallas(m, c, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_morphology.binary_closing(m, clip_mask=c)))


# the widths and heights where the CUDA kernel's 32-pixel words and
# 32-row bands end (csrc/closing.cu), below the disc's size included
@pytest.mark.parametrize("H", [1, 6, 7, 33])
@pytest.mark.parametrize("W", [31, 32, 33, 63, 64, 65, 255, 256, 257])
def test_plain_closing_word_boundary_shapes_match_jax(W, H):
    rng = np.random.RandomState(1000 * H + W)
    masks = np.stack([rng.rand(H, W) < d for d in (0.3, 0.6, 0.9)])
    clip = np.ones_like(masks)
    clip[1, :, :W - W % 32] = False          # the last, partial word
    clip[2, H // 3:, 1:W - 1] = False
    _assert_closing_matches_jax(masks, clip)


@pytest.mark.parametrize("x", range(29, 36))
def test_plain_closing_pixel_at_word_edge_matches_jax(x):
    """One set pixel (closes to itself) and one hole (closes shut) at
    columns 29-35, across the first word boundary."""
    masks = np.zeros((2, 12, 70), bool)
    masks[0, 6, x] = True
    masks[1] = True
    masks[1, 6, x] = False
    _assert_closing_matches_jax(masks, np.ones_like(masks))


@pytest.mark.parametrize("edge", [31, 32, 33, 63, 64, 65])
def test_plain_closing_clip_on_word_edge_matches_jax(edge):
    rng = np.random.RandomState(edge)
    masks = rng.rand(2, 40, 96) < 0.6
    clip = np.zeros_like(masks)
    clip[0, 3:37, 2:edge] = True
    clip[1, :, edge:] = True
    _assert_closing_matches_jax(masks, clip)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(7)
    B, H, W = 7, 37, 45
    clip = torch.from_numpy(_clip_boxes(B, H, W))
    masks = torch.from_numpy(_masks(rng, (B, H, W), 0.4))
    before = dict(cuda_lib.launches)
    got = binary_closing(masks, clip)
    assert got.dtype == torch.bool and got.shape == (B, H, W)
    assert torch.equal(got, binary_closing_reference(masks, clip))
    # the plain version on the CPU is no kernel launch
    assert cuda_lib.launches == before


def test_wrapper_raises_on_bad_input():
    m = torch.zeros(2, 8, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="torch.bool"):
        binary_closing(m.to(torch.uint8), m)
    with pytest.raises(ValueError, match="torch.bool"):
        binary_closing(m, m.float())
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        binary_closing(m[0], m[0])
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        binary_closing(m[:0], m[:0])
    with pytest.raises(ValueError, match="contiguous"):
        binary_closing(m.transpose(1, 2), m)
    with pytest.raises(ValueError, match="differ in shape"):
        binary_closing(m, m[:1])
    with pytest.raises(ValueError, match="device"):
        binary_closing(m.to("meta"), m.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        binary_closing(m, m.to("meta"))
