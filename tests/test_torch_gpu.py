"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without CUDA.  The file
imports no JAX, so it also runs on a machine with only PyTorch and the
CUDA toolkit (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Stated tolerances: gather_db within one ulp of its output dtype (the same
float32 arithmetic; log10f may round differently by one ulp), the pools
bit-equal with equal NaN positions, the closing bit-equal.  The
train-mode BatchNorm + ReLU kernels against their plain versions run on
the card: the statistics and the gradient sums within 1e-5 of the sum of
their terms' magnitudes (float32 sums in another order), the output, the
running statistics and dz bit-equal given the same statistics and sums.
"""

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.ops import bn_relu as bnr
from crimac_unet_tpu_torch.ops import cuda_lib
from crimac_unet_tpu_torch.ops.closing import (binary_closing,
                                               binary_closing_reference)
from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                 gather_db_reference)
from crimac_unet_tpu_torch.ops.pool import (maxpool2x2, maxpool2x2_reference,
                                            relu_pool_skip,
                                            relu_pool_skip_reference)
from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8

HP, WP, CF, WIN = 96, 128, 4, (32, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py")
    return torch.device("cuda")


def _raw_slab(rng):
    slab = rng.lognormal(np.log(1e-6), 2.0, (HP, WP, CF)).astype(np.float32)
    slab[5:9, 10:20, 0] = np.nan
    slab[50:52, :, 2] = np.inf
    slab[60:62, 3:40, 1] = -np.inf
    slab[70, 70:90, 3] = -1e-3          # negative sv: NaN through log10
    return slab


def _assert_within_one_ulp(got, want):
    """Equal NaN positions; elsewhere |got - want| <= one ulp of want's
    binade in want's dtype."""
    assert got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    m = ~torch.isnan(want)
    g, w = got[m].float(), want[m].float()
    bits = {torch.float32: 24, torch.bfloat16: 8}[want.dtype]
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - bits)
    assert torch.all((g - w).abs() <= ulp)


def _assert_equal_nan(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got.float(), nan=0.0),
                       torch.nan_to_num(want.float(), nan=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_gather_db_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(11)
    raw = _raw_slab(rng)[:70]         # rows 70..95 read as the zero pad
    slab = torch.from_numpy(_quantize_db_u8(raw)) if dtype == torch.uint8 \
        else torch.from_numpy(raw).to(dtype)
    y0s = torch.from_numpy(rng.randint(0, HP - WIN[0] + 1, 16).astype(
        np.int32)).to(cuda)
    x0s = torch.from_numpy(rng.randint(0, WP - WIN[1] + 1, 16).astype(
        np.int32)).to(cuda)
    before = cuda_lib.launches["gather_db"]
    for out_dtype in (torch.float32, torch.bfloat16):
        for border in (None, (9, 80, 6, 120)):
            for scaled in (False, True):
                args = (slab.to(cuda), y0s, x0s, WIN, border, scaled,
                        out_dtype)
                got = gather_db(*args)
                want = gather_db_reference(*args)
                torch.cuda.synchronize()
                _assert_within_one_ulp(got.cpu(), want.cpu())
    assert cuda_lib.launches["gather_db"] == before + 8


def _at_offset(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` elements into its
    storage, so its address is off the kernels' vector alignment."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
@pytest.mark.parametrize("cf", [1, 2, 3, 4])
def test_gather_db_kernel_narrow_paths_match_plain(cuda, dtype, cf):
    """Cf 1-4, odd and even start columns (negative and past the slab's
    right edge too), windows 31 and 13 wide (rows not a multiple of the
    kernel's 8-element runs), and a slab off 16-byte alignment: the
    narrow-load and element-wise paths of csrc/gather_db.cu."""
    rng = np.random.RandomState(20 + cf)
    raw = np.ascontiguousarray(_raw_slab(rng)[:70, :, :cf])
    slab = torch.from_numpy(_quantize_db_u8(raw)) if dtype == torch.uint8 \
        else torch.from_numpy(raw).to(dtype)
    slab = slab.to(cuda)
    before = cuda_lib.launches["gather_db"]
    calls = 0
    for ww in (31, 13):
        y0s = torch.from_numpy(rng.randint(-2, HP - 20, 9).astype(
            np.int32)).to(cuda)
        x0s = torch.tensor([0, 1, 2, 3, 5, 64, -3, WP - ww, WP - ww + 4],
                           dtype=torch.int32, device=cuda)
        for s in (slab, _at_offset(slab, 1)):
            for border in (None, (9, 60, 6, 120)):
                for out_dtype in (torch.float32, torch.bfloat16):
                    args = (s, y0s, x0s, (24, ww), border, False, out_dtype)
                    got = gather_db(*args)
                    want = gather_db_reference(*args)
                    torch.cuda.synchronize()
                    _assert_within_one_ulp(got.cpu(), want.cpu())
                    calls += 1
    assert cuda_lib.launches["gather_db"] == before + calls


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (3, 6, 10, 5)])
def test_pool_kernels_bit_equal_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g) * 2.0
    idx = torch.randperm(x.numel(), generator=g)[:5]
    x.view(-1)[idx] = torch.tensor([float("nan"), float("nan"),
                                    float("inf"), float("-inf"), -0.0])
    x = x.to(cuda, dtype)
    before = dict(cuda_lib.launches)
    _assert_equal_nan(maxpool2x2(x), maxpool2x2_reference(x))
    for got, want in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
        _assert_equal_nan(got, want)
    assert cuda_lib.launches["maxpool2x2"] == before["maxpool2x2"] + 1
    assert cuda_lib.launches["relu_pool_skip"] == \
        before["relu_pool_skip"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pool_probe_nhwc", "pool_probe_lane128",
                                  "pool_probe_packed"])
@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 2, 2, 64),
                                   (3, 6, 10, 64), (4, 256, 256, 64),
                                   (2, 8, 16, 128), (2, 4, 6, 6)])
def test_pool_probe_kernels_bit_equal_plain(cuda, name, shape):
    """P1-P3 against their plain versions and F.max_pool2d (bfloat16, NaN,
    +-Inf and -0 written in); P2 takes C = 64 only, P1 a multiple of 8."""
    from crimac_unet_tpu_torch.ops.pool_probe import VARIANTS
    kernel, plain, _ = VARIANTS[name]
    g = torch.Generator().manual_seed(9)
    x = torch.randn(shape, generator=g)
    idx = torch.randperm(x.numel(), generator=g)[:5]
    x.view(-1)[idx] = torch.tensor([float("nan"), float("nan"),
                                    float("inf"), float("-inf"), -0.0])
    x = x.to(cuda, torch.bfloat16)
    C = shape[3]
    if (name == "pool_probe_lane128" and C != 64) or \
            (name == "pool_probe_nhwc" and C % 8):
        with pytest.raises(ValueError):
            kernel(x)
        return
    before = cuda_lib.launches[name]
    got = kernel(x)
    _assert_equal_nan(got, plain(x))
    _assert_equal_nan(got, maxpool2x2_reference(x))
    torch.cuda.synchronize()
    assert cuda_lib.launches[name] == before + 1


@pytest.mark.gpu
def test_pool_probe_kernels_raise_on_bad_input(cuda):
    from crimac_unet_tpu_torch.ops.pool_probe import (pool_nhwc,
                                                      pool_packed)
    with pytest.raises(ValueError, match="shared memory"):
        pool_nhwc(torch.zeros(1, 2, 1024, 64, device=cuda,
                              dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="even C"):
        pool_packed(torch.zeros(1, 2, 2, 5, device=cuda,
                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        pool_packed(torch.zeros(1, 2, 2, 4, device=cuda))


@pytest.mark.gpu
def test_kernels_raise_on_bad_input(cuda):
    with pytest.raises(ValueError, match="even"):
        maxpool2x2(torch.zeros(1, 5, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="different devices"):
        gather_db(torch.zeros(8, 8, 4, device=cuda),
                  torch.zeros(2, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32), (4, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 256, 256), (3, 37, 45), (2, 5, 6),
                                   (1, 1, 1)])
def test_closing_kernel_bit_equal_plain(cuda, shape):
    g = torch.Generator().manual_seed(13)
    B, H, W = shape
    before = cuda_lib.launches["binary_closing"]
    for density in (0.0, 0.3, 0.75, 1.0):
        mask = torch.rand(shape, generator=g) < density
        clip = torch.zeros(shape, dtype=torch.bool)
        for b in range(B):      # random boxes, some touching the edges
            y0, x0 = (int(torch.randint(0, n // 2 + 1, (1,), generator=g))
                      for n in (H, W))
            y1 = int(torch.randint(y0, H + 1, (1,), generator=g))
            x1 = int(torch.randint(x0, W + 1, (1,), generator=g))
            clip[b, y0:y1, x0:x1] = True
        clip[0] = True
        mask, clip = mask.to(cuda), clip.to(cuda)
        got = binary_closing(mask, clip)
        want = binary_closing_reference(mask, clip)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want), density
    assert cuda_lib.launches["binary_closing"] == before + 4


def _closing_matches_plain(mask, clip):
    got = binary_closing(mask, clip)
    want = binary_closing_reference(mask, clip)
    torch.cuda.synchronize()
    return got.dtype == torch.bool and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 6, 7, 33])
@pytest.mark.parametrize("W", [31, 32, 33, 63, 64, 65, 255, 256, 257])
def test_closing_kernel_word_boundary_shapes(cuda, W, H):
    """Where csrc/closing.cu's 32-pixel words and 32-row bands end; each
    also at an address off 16 bytes (the byte-gather path)."""
    rng = np.random.RandomState(1000 * H + W)
    mask = torch.from_numpy(np.stack([rng.rand(H, W) < d
                                      for d in (0.3, 0.6, 0.9)]))
    clip = torch.ones_like(mask)
    clip[1, :, :W - W % 32] = False
    clip[2, H // 3:, 1:W - 1] = False
    mask, clip = mask.to(cuda), clip.to(cuda)
    before = cuda_lib.launches["binary_closing"]
    assert _closing_matches_plain(mask, clip)
    assert _closing_matches_plain(_at_offset(mask, 1), _at_offset(clip, 3))
    assert cuda_lib.launches["binary_closing"] == before + 2


@pytest.mark.gpu
def test_closing_kernel_word_edges(cuda):
    """One set pixel and one hole at each of columns 29-35, and clip
    boxes ending on a word edge +-1."""
    for x in range(29, 36):
        mask = torch.zeros((2, 12, 64), dtype=torch.bool)
        mask[0, 6, x] = True
        mask[1] = True
        mask[1, 6, x] = False
        mask = mask.to(cuda)
        assert _closing_matches_plain(mask, torch.ones_like(mask)), x
    g = torch.Generator().manual_seed(17)
    for edge in (31, 32, 33, 63, 64, 65):
        mask = torch.rand((2, 40, 96), generator=g) < 0.6
        clip = torch.zeros_like(mask)
        clip[0, 3:37, 2:edge] = True
        clip[1, :, edge:] = True
        assert _closing_matches_plain(mask.to(cuda), clip.to(cuda)), edge


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("scaled", [False, True])
def test_gather_db_kernel_slab_window_matches_plain(cuda, dtype, scaled):
    """Slab mode's front end: one window of the whole grid padded to the
    pooling alignment (N = 1, start (0, 0), 1120 x 1120 over a 1096-row
    shipped slab of 1080 columns): rows past the slab read as zeros and
    the columns past Wp and the rectangle's outside come out 0.0."""
    rng = np.random.RandomState(31)
    Hs, Hp, Wp, H16, W16 = 1096, 1104, 1080, 1120, 1120
    raw = rng.lognormal(np.log(1e-6), 2.0, (Hs, Wp, CF)).astype(np.float32)
    raw[5:9, 10:200, 0] = np.nan
    raw[500:502, :, 2] = np.inf
    raw[600:602, 3:400, 1] = -np.inf
    slab = torch.from_numpy(_quantize_db_u8(raw)) if dtype == torch.uint8 \
        else torch.from_numpy(raw).to(dtype)
    slab = slab.to(cuda)
    origin = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = cuda_lib.launches["gather_db"]
    for border in ((20, 1040, 20, 1060), (0, Hp, 0, Wp)):
        for out_dtype in (torch.bfloat16, torch.float32):
            args = (slab, origin, origin, (H16, W16), border, scaled,
                    out_dtype)
            got = gather_db(*args)
            want = gather_db_reference(*args)
            torch.cuda.synchronize()
            _assert_within_one_ulp(got.cpu(), want.cpu())
            assert not got[0, Hp:].any() and not got[0, :, Wp:].any()
    assert cuda_lib.launches["gather_db"] == before + 4


@pytest.mark.gpu
def test_relu_pool_skip_kernel_slab_geometry_bit_equal_plain(cuda):
    """K3 at slab mode's level-0 activation, (1, 1120, 1120, 64) bf16."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((1, 1120, 1120, 64), generator=g) * 2.0
    x.view(-1)[:7] = torch.tensor([float("nan")] * 3 + [float("inf")] * 2
                                  + [float("-inf"), -0.0])
    x = x.to(cuda, torch.bfloat16)
    before = cuda_lib.launches["relu_pool_skip"]
    for got, want in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
        _assert_equal_nan(got, want)
    assert cuda_lib.launches["relu_pool_skip"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 16])
def test_closing_kernel_train_mask_shapes(cuda, B):
    """K4 at the train step's mask shapes (batch 4 and 16, patch 256):
    random masks under full and inner clip boxes, bit-equal to plain."""
    g = torch.Generator().manual_seed(B)
    mask = torch.rand((B, 256, 256), generator=g) < 0.4
    clip = torch.ones_like(mask)
    clip[1::2, :, :20] = False
    clip[::3, 230:] = False
    mask, clip = mask.to(cuda), clip.to(cuda)
    before = cuda_lib.launches["binary_closing"]
    got = binary_closing(mask, clip)
    assert torch.equal(got, binary_closing_reference(mask, clip))
    assert cuda_lib.launches["binary_closing"] == before + 1


@pytest.mark.gpu
def test_gather_crops_on_card_equals_cpu(cuda):
    from crimac_unet_tpu_torch.data.device_pool import gather_crops
    g = torch.Generator().manual_seed(3)
    data = torch.rand((3, 4, 300, 500), generator=g)
    labels = torch.randint(-100, 30, (3, 300, 500), generator=g,
                           dtype=torch.int32)
    idx = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    starts = torch.tensor([[0, 0], [44, 244], [-5, 9000], [100, 3]],
                          dtype=torch.int32)
    want = gather_crops(data, labels, idx, starts, (256, 256))
    got = gather_crops(data.to(cuda), labels.to(cuda), idx.to(cuda),
                       starts.to(cuda), (256, 256))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One float32 train step (TF32 off, augmentation off) on the card and
    on the CPU from the same weights and batch: the labels after the
    train chain identical (K4 against the plain closing), the loss within
    1e-4 relative and each update within 5e-2 relative in max-norm plus
    one ulp of its parameter (cuDNN and the CPU sum in other orders; a
    conv bias ahead of a BatchNorm has zero gradient and is skipped)."""
    from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
    from crimac_unet_tpu_torch.ops import augment
    from crimac_unet_tpu_torch.pipeline import engine
    monkeypatch.setattr(augment, "augment_train",
                        lambda gen, d, lab: (d, lab))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = {"patch_size": [64, 64], "depth": 3, "start_filts": 8,
           "frequencies": [18, 38, 120, 200], "lr": 0.005,
           "lr_reduction": 0.5, "lr_step": 1000, "momentum": 0.95,
           "compute_dtype": "float32"}
    rng = np.random.RandomState(2)
    data = torch.from_numpy(rng.lognormal(np.log(3e-6), 1.5, (4, 4, 64, 64))
                            .astype(np.float32))
    labels = np.zeros((4, 64, 64), np.int32)
    labels[:, 10:30, 12:40] = 27
    labels[:, 40:52, 20:50] = 1
    labels[0, :, 56:] = -100
    labels = torch.from_numpy(labels)
    out = {}
    for dev in ("cpu", cuda):
        net = init_train_(build_unet(cfg), torch.Generator().manual_seed(1))
        p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
        net.to(dev)
        chain = engine._train_labels(data.to(dev), labels.to(dev), -1)
        state = engine.init_train_state(net, cfg)
        loss = engine.make_train_step(cfg)(state, data.to(dev),
                                           labels.to(dev), None)
        out[str(dev)] = (chain.cpu(), float(loss), p0,
                         {n: p.detach().cpu() for n, p in
                          net.named_parameters()})
    (c0, l0, p0, p1), (c1, l1, _, q1) = out["cpu"], out[str(cuda)]
    assert torch.equal(c0, c1)
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    for name in p0:
        if name.endswith(".bias") and (".main.0." in name or ".main.3." in
                                       name or ".conv" in name):
            continue
        up, ref = q1[name] - p0[name], p1[name] - p0[name]
        ulp = float(torch.max(torch.abs(p0[name])) * 2 ** -23)
        assert float((up - ref).abs().max()) <= \
            5e-2 * float(ref.abs().max()) + ulp, name


@pytest.mark.gpu
def test_zarr_pool_on_card_equals_cpu(cuda, tmp_path):
    """ZarrSamplePool built on the card (several chunks and a shifted
    tail) holds the CPU pool's canvases, and its gather, crops across
    the survey's edges included, equals the host crops."""
    from crimac_unet_tpu_torch.data.device_pool import (ZarrSamplePool,
                                                        gather_crops)
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    reader = DataReaderZarr(make_zarr_survey(
        tmp_path, year=2017, n_echograms=2, H=100, W=200, seed=7))
    freqs = [18, 38, 120, 200]
    cpu = ZarrSamplePool([reader], freqs, WIN, device="cpu", chunk_pings=96)
    card = ZarrSamplePool([reader], freqs, WIN, device=cuda, chunk_pings=96)
    assert torch.equal(card.data.cpu(), cpu.data)
    assert torch.equal(card.labels.cpu(), cpu.labels)
    centers = [(0, 0), (-10, 5), (99, 399), (120, 410), (50, 200),
               (30, -20)]
    idx, starts = (torch.from_numpy(a).to(cuda) for a in
                   card.prepare_batch([(reader, c) for c in centers]))
    d, lab = gather_crops(card.data, card.labels, idx, starts, WIN)
    for b, c in enumerate(centers):
        assert torch.equal(d[b].cpu(), torch.from_numpy(
            reader.crop_data(c, WIN, freqs)))
        assert torch.equal(lab[b].cpu(), torch.from_numpy(
            reader.crop_labels(c, WIN).astype(np.int32)))


@pytest.mark.gpu
def test_meta_gather_on_card_matches_cpu(cuda):
    """gather_meta_crops on the card against the CPU on the same vectors,
    zero seabed rows included: rtol 1e-5, atol 1e-6, Inf and NaN in the
    same places."""
    from crimac_unet_tpu_torch.data.device_pool import (META_ORDER,
                                                        gather_meta_crops)
    rng = np.random.RandomState(7)
    seabed = rng.randint(0, 60, (3, 90)).astype(np.float32)
    seabed[:, ::7] = 0.0
    vec = [torch.from_numpy(a) for a in (
        rng.rand(3, 90).astype(np.float32), rng.rand(3, 90).astype(
            np.float32), seabed, rng.rand(3).astype(np.float32),
        np.array([90, 70, 40], np.int32))]
    idx = torch.from_numpy(rng.randint(0, 3, 12).astype(np.int32))
    starts = torch.from_numpy(np.stack(
        [rng.randint(-10, 120, 12), rng.randint(-10, 150, 12)],
        axis=1).astype(np.int32))
    want = gather_meta_crops(*vec, idx, starts, WIN, META_ORDER)
    got = gather_meta_crops(*[v.to(cuda) for v in vec], idx.to(cuda),
                            starts.to(cuda), WIN, META_ORDER).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.gpu
def test_crimac_ops_on_card_match_plain(cuda):
    """The kernels called as torch.ops.crimac.* (as an exported graph
    calls them) against their plain versions: gather_db within one ulp,
    the pools and the closing bit-equal; each call counts one launch."""
    rng = np.random.RandomState(5)
    slab = torch.from_numpy(_raw_slab(rng)).to(cuda)
    y0s = torch.from_numpy(rng.randint(0, HP - WIN[0] + 1, 8).astype(
        np.int32)).to(cuda)
    x0s = torch.from_numpy(rng.randint(0, WP - WIN[1] + 1, 8).astype(
        np.int32)).to(cuda)
    ops = torch.ops.crimac
    before = dict(cuda_lib.launches)
    for border in (None, [4, 80, 6, 120]):
        _assert_within_one_ulp(
            ops.gather_db(slab, y0s, x0s, *WIN, border, False,
                          torch.bfloat16),
            gather_db_reference(slab, y0s, x0s, WIN, border, False,
                                torch.bfloat16))
    x = (torch.randn((2, 16, 32, 64), generator=torch.Generator(
        ).manual_seed(3)) * 2).to(cuda, torch.bfloat16)
    x.view(-1)[::97] = float("nan")
    _assert_equal_nan(ops.maxpool2x2(x), maxpool2x2_reference(x))
    for got, want in zip(ops.relu_pool_skip(x), relu_pool_skip_reference(x)):
        _assert_equal_nan(got, want)
    mask = torch.rand((3, 40, 70), device=cuda) < 0.4
    clip = torch.ones_like(mask)
    clip[:, :5] = False
    assert torch.equal(ops.binary_closing(mask, clip),
                       binary_closing_reference(mask, clip))
    assert {k: cuda_lib.launches[k] - before[k] for k in before} == dict(
        dict.fromkeys(before, 0), gather_db=2, maxpool2x2=1,
        relu_pool_skip=1, binary_closing=1)


@pytest.mark.gpu
@pytest.mark.parametrize("fold_bn", [True, False])
def test_artifact_on_card_launches_the_kernels(cuda, tmp_path, fold_bn):
    """An artifact exported and loaded on the card launches K1 once and K3
    once a call (K2 with fold_bn: false) and equals the eager serving
    forward; one exported on the CPU and loaded on the card does too."""
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.export import (export_predictor,
                                                       load_predictor,
                                                       make_serving_forward,
                                                       save_exported)
    cfg = {"patch_size": [32, 32], "frequencies": [18, 38, 120, 200],
           "depth": 3, "start_filts": 8, "compute_dtype": "float32",
           "fold_bn": fold_bn}
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        0)).state_dict()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.lognormal(np.log(1e-6), 2.0, (3, 32, 32, 4))
                         .astype(np.float32)).to(cuda)
    x[0, :2, :2, 0] = float("nan")
    pool = "relu_pool_skip" if fold_bn else "maxpool2x2"
    live = make_serving_forward(build_unet(cfg), sd, cfg, device=cuda)
    with torch.no_grad():
        want = live(x)
    for where in ("cuda", "cpu"):
        path = tmp_path / f"{where}.pt2"
        save_exported(export_predictor(build_unet(cfg), sd, cfg,
                                       device=where), path)
        predict = load_predictor(path)
        cuda_lib.reset_launches()
        got = predict(x)
        torch.cuda.synchronize()
        assert cuda_lib.launches["gather_db"] == 1
        assert cuda_lib.launches[pool] == 1
        assert sum(cuda_lib.launches.values()) == 2
        assert torch.equal(got, want), where


@pytest.mark.gpu
def test_nccl_world_of_one_steps_like_no_group(cuda):
    """A CUDA rank joins over NCCL; every collective of the train step
    runs in a world of one rank and leaves the step bit-equal to the step
    without a group (cuDNN deterministic, TF32 off)."""
    import torch.distributed as dist

    from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
    from crimac_unet_tpu_torch.parallel import mesh as pmesh
    from crimac_unet_tpu_torch.parallel.multihost_check import (CONFIG,
                                                                free_port)
    from crimac_unet_tpu_torch.pipeline import engine

    rng = np.random.RandomState(4)
    data = torch.from_numpy(rng.lognormal(np.log(3e-6), 1.5, (4, 4, 32, 32))
                            .astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.choice([0, 27, 1], (4, 32, 32)).astype(
        np.int32)).to(cuda)

    def train(mesh):
        net = init_train_(build_unet(CONFIG),
                          torch.Generator().manual_seed(0)).to(cuda)
        state = engine.init_train_state(net, CONFIG)
        step = engine.make_train_step(CONFIG, mesh)
        gen = torch.Generator(device=cuda).manual_seed(3)
        losses = [float(step(state, data, labels, gen)) for _ in range(2)]
        return losses, [p.detach().clone() for p in net.parameters()]

    det, tf32 = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = train(None)
        assert pmesh.init_distributed(
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0, device="cuda:0")
        try:
            assert dist.get_backend() == "nccl"
            got = train(pmesh.get_mesh(0))
        finally:
            pmesh.shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32 = tf32
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_step_like_one(cuda):
    """Two ranks on the one card (gloo over CUDA tensors) against one
    process on the whole batch: loss and parameter checksum within rtol
    1e-5 (``multihost_check``)."""
    from crimac_unet_tpu_torch.parallel.multihost_check import \
        run_two_process_check
    res = run_two_process_check(timeout=300, device="cuda")
    assert np.isfinite(res["loss"]) and res["checksum"] > 0


def _unet_bn_shapes(B, size=256, depth=5, start_filts=64):
    """The (M, C) rows of the flagship U-Net's train-mode BatchNorm layers,
    one a level (each level has two encoder and two decoder layers, the
    bottom level two)."""
    return [(B * (size >> i) ** 2, start_filts << i) for i in range(depth)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [4, 16])
def test_bn_relu_kernels_match_plain_at_unet_shapes(cuda, B, dtype):
    gen = torch.Generator(device=cuda).manual_seed(B)
    eps = 1e-5
    for M, C in _unet_bn_shapes(B) + [(B * 37, 12)]:
        z = (torch.randn((M, C), generator=gen, device=cuda) * 2 + .3
             ).to(dtype)
        d = torch.randn((M, C), generator=gen, device=cuda).to(dtype)
        w = torch.rand(C, generator=gen, device=cuda) + .5
        b = torch.rand(C, generator=gen, device=cuda) - .5
        where = f"{B}: ({M}, {C}) {dtype}"
        before = dict(cuda_lib.launches)

        stats = bnr._STATS(z)
        want = bnr.stats_reference(z)
        scale = torch.stack([want[1].sqrt(), want[1]])
        assert torch.all((stats - want).abs() <= 1e-5 * scale), where

        rm, rv = torch.rand(C, device=cuda), torch.rand(C, device=cuda) + .5
        rm2, rv2 = rm.clone(), rv.clone()
        y = bnr._APPLY(z, stats, w, b, rm, rv, eps)
        assert torch.equal(y, bnr.apply_reference(z, stats, w, b, rm2, rv2,
                                                  eps)), where
        assert torch.equal(rm, rm2) and torch.equal(rv, rv2), where

        sums = bnr._GRAD_STATS(d, z, stats, w, b, eps)
        want = bnr.grad_stats_reference(d, z, stats, w, b, eps)
        mean, _, rstd, mul, _ = bnr._channels(stats, w, eps)
        g, c = bnr._relu_grad(d, z, mean, mul, b)
        mag = torch.stack([g.abs().sum(0), (g * c).abs().sum(0) * rstd])
        assert torch.all((sums - want).abs() <= 1e-5 * mag), where

        dz = bnr._GRAD_APPLY(d, z, stats, w, b, sums, eps, 1.0 / M)
        assert torch.equal(dz, bnr.grad_apply_reference(
            d, z, stats, w, b, sums, eps, 1.0 / M)), where
        assert all(cuda_lib.launches[k] == before[k] + 1 for k in (
            "bn_relu_stats", "bn_relu_apply", "bn_relu_grad_stats",
            "bn_relu_grad_apply")), where


@pytest.mark.gpu
def test_bn_relu_train_gives_the_same_bits_twice(cuda):
    """Forward and backward of one level-0 layer of a batch-16 step, twice:
    no float atomics, so the same bits (the step's replay relies on it)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    z0 = torch.randn((16, 64, 256, 256), generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ct = torch.randn(z0.shape, generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = []
    for _ in range(2):
        bn = torch.nn.BatchNorm2d(64).to(cuda)
        z = z0.clone().requires_grad_(True)
        y = bnr.bn_relu_train(z, bn)
        y.backward(ct)
        out.append((y.detach(), z.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bn_relu_backward_of_a_channel_slice_cotangent(cuda):
    """Level 0 of a batch-16 step under a late metadata inject: the op's
    output goes into ``torch.cat([y, m], dim=1)``, whose backward hands
    the op a channel slice of a (65-channel) channels_last gradient; the
    kernels give the same bits as from that slice made dense."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    z0 = torch.randn((16, 64, 256, 256), generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wide = torch.randn((16, 65, 256, 256), generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = []
    for ct in (wide, wide[:, :64].contiguous(
            memory_format=torch.channels_last)):
        bn = torch.nn.BatchNorm2d(64).to(cuda)
        z = z0.clone().requires_grad_(True)
        y = bnr.bn_relu_train(z, bn)
        if ct is wide:
            y = torch.cat([y, z0[:, :1]], dim=1)
        y.backward(ct)
        out.append((z.grad, bn.weight.grad, bn.bias.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_step_launches_each_bn_relu_kernel_per_layer(cuda):
    """One bfloat16 train step of the depth-5 U-Net at batch 16: each of
    the four kernels launches once for each of its 18 BatchNorm layers."""
    from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
    from crimac_unet_tpu_torch.pipeline import engine
    cfg = {"patch_size": [64, 64], "depth": 5, "start_filts": 8,
           "frequencies": [18, 38, 120, 200], "lr": 0.01,
           "lr_reduction": 0.5, "lr_step": 250, "momentum": 0.95,
           "compute_dtype": "bfloat16"}
    rng = np.random.RandomState(3)
    data = torch.from_numpy(rng.lognormal(np.log(3e-6), 1.5, (16, 4, 64, 64))
                            .astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.choice([0, 27, 1], (16, 64, 64)).astype(
        np.int32)).to(cuda)
    net = init_train_(build_unet(cfg), torch.Generator().manual_seed(0))
    state = engine.init_train_state(net.to(cuda), cfg)
    step = engine.make_train_step(cfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cuda_lib.reset_launches()
    loss = float(step(state, data, labels, gen))
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    for k in ("bn_relu_stats", "bn_relu_apply", "bn_relu_grad_stats",
              "bn_relu_grad_apply"):
        assert cuda_lib.launches[k] == 18, (k, dict(cuda_lib.launches))


GRAPH_CONFIGS = {
    "unet": {"depth": 3, "start_filts": 8},
    "segformer": {"architecture": "segformer", "hidden_sizes": [16, 32],
                  "depths": [1, 1], "num_attention_heads": [1, 2],
                  "sr_ratios": [2, 1], "patch_sizes": [7, 3],
                  "strides": [4, 2], "mlp_ratios": [4, 4],
                  "decoder_hidden_size": 32, "drop_path_rate": 0.0,
                  "classifier_dropout_prob": 0.0},
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(GRAPH_CONFIGS))
def test_train_graph_steps_like_the_eager_step(cuda, arch):
    """Three bfloat16 train steps with ``train_graph`` (forward, loss and
    backward replayed as one CUDA graph) and eagerly, from the same
    weights, batches and augmentation seed: the losses within 1e-3
    relative, and each parameter's and BatchNorm statistic's change
    within 2e-2 of the larger of its eager change's and the median
    leaf's, in max-norm, as the benchmark's ``update_gap`` takes them
    (the same kernels; some backward kernels, flash attention's among
    them, add by atomics in a varying order, and a bias ahead of a
    BatchNorm moves by that rounding alone).  The parameters hold the
    graph's gradients, the same tensors every step."""
    from crimac_unet_tpu_torch.models import build_model, init_train_
    from crimac_unet_tpu_torch.pipeline import engine
    base = dict(GRAPH_CONFIGS[arch], patch_size=[64, 64],
                frequencies=[18, 38, 120, 200], lr=0.01, lr_reduction=0.5,
                lr_step=250, momentum=0.95, compute_dtype="bfloat16")
    rng = np.random.RandomState(4)
    batches = [(torch.from_numpy(rng.lognormal(np.log(3e-6), 1.5,
                                               (8, 4, 64, 64))
                                 .astype(np.float32)).to(cuda),
                torch.from_numpy(rng.choice([0, 27, 1], (8, 64, 64))
                                 .astype(np.int32)).to(cuda))
               for _ in range(3)]
    out = {}
    for graph in (False, True):
        cfg = dict(base, train_graph=graph)
        net = init_train_(build_model(cfg), torch.Generator().manual_seed(0))
        state = engine.init_train_state(net.to(cuda), cfg)
        start = {k: v.detach().clone() for k, v in net.state_dict().items()}
        step = engine.make_train_step(cfg)
        gen = torch.Generator(device=cuda).manual_seed(1)
        losses, grads = [], []
        for data, labels in batches:
            losses.append(float(step(state, data, labels, gen)))
            grads.append([p.grad.data_ptr() for p in net.parameters()])
        out[graph] = (losses, start, net.state_dict(), grads)
    (l0, s0, e0, _), (l1, s1, e1, g1) = out[False], out[True]
    for a, b in zip(l1, l0):
        assert abs(a - b) <= 1e-3 * abs(b)
    assert g1[0] == g1[1] == g1[2]
    moved = {}
    for k in e0:
        assert torch.equal(s0[k], s1[k]), k
        if not e0[k].is_floating_point():
            assert torch.equal(e0[k], e1[k]), k
            continue
        eager = e0[k] - s0[k]
        moved[k] = (float(eager.abs().max()),
                    float((e1[k] - s1[k] - eager).abs().max()))
    median = float(np.median([m for m, _ in moved.values()]))
    for k, (m, gap) in moved.items():
        assert gap <= 2e-2 * max(m, median), (k, gap, m, median)
