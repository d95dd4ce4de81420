"""PyTorch U-Net for echogram segmentation (train and eval forward).

The flagship model of the reference (crimac_unet/models/unet.py:169-391)
and of the JAX package (crimac_unet_tpu/models/unet.py): an encoder of
``depth`` conv-BN-ReLU x2 blocks with 2x2 max pools between levels, a
decoder of 2x2 transpose-conv upsampling + skip concat + conv-BN-ReLU x2,
and a 1x1 logits head with no softmax.  ``start_filts`` channels double
per level (4 -> 64 -> ... -> 1024 at depth 5, ~31M parameters).

* Parameter names are the reference's state-dict names
  (``down_convs.{i}.main.{0,1,3,4}``, ``up_convs.{i}.{upconv,conv1,bn1,
  conv2,bn2}``, ``conv_final``), so reference ``.pt`` files and the JAX
  package's ``save_torch_checkpoint`` output load as they are.
* ``forward`` takes NHWC (the JAX package's layout) and runs channels_last
  inside; logits come back NHWC float32.
* Casting follows flax: parameters are float32; conv inputs and weights are
  cast to the compute ``dtype``, the bias is added in the compute dtype,
  BatchNorm runs in float32 and casts back.  Gradients reach the float32
  parameters through the casts.
* Train mode (``model.train()``) is flax's BatchNorm, not torch's: batch
  statistics in float32 with the fast variance ``max(0, E[x^2] - E[x]^2)``
  (biased), running statistics ``0.9 * running + 0.1 * batch`` (flax's
  momentum 0.9), eps 1e-5; so the statistics mean the same in both
  packages' checkpoints.  Every train-mode BatchNorm is followed by a
  ReLU, and the two run as one autograd op, ``bn_relu_train``
  (ops/bn_relu.py: hand-written CUDA kernels forward and backward on the
  card, the plain PyTorch law on the CPU), held to ``_bn_train`` + ReLU,
  the law kept here.  The conv bias stays in ``_conv``, added in the
  compute dtype as flax adds it.
* Metadata channels (``meta_channels``): early inject widens the input to
  ``len(frequencies) + get_in_channels(meta_channels)`` bands; late inject
  (``late_meta_inject``) runs the reference's per-pixel MLP over the
  metadata and concatenates its one channel before ``conv_final``
  (reference unet.py:346-391, state-dict names
  ``post_processing_weights.main.{0,2,4}``).
* In eval mode the level-0 pool runs through the hand-written kernels
  (ops/pool.py): with BatchNorm folded (``use_bn=False``) the raw conv2
  output goes to ``relu_pool_skip``; with BatchNorm it is ``maxpool2x2``
  after the ReLU.  Deeper levels, and every level in train mode (the
  kernels have no backward, as the Pallas ones have no VJP), use
  ``F.max_pool2d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bn_relu import BN_MOMENTUM, bn_relu_train
from ..ops.pool import maxpool2x2, relu_pool_skip

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _conv(x, conv, dtype):
    y = F.conv2d(x, conv.weight.to(dtype), None, padding=conv.padding)
    return y + conv.bias.to(dtype).view(1, -1, 1, 1)


def _bn(x, bn, dtype):
    """Eval BatchNorm in float32 (flax's order of operations), cast back."""
    if isinstance(bn, nn.Identity):
        return x
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
    return (y + bn.bias.view(1, -1, 1, 1)).to(dtype)


def _bn_relu(x, bn, dtype):
    """Eval BatchNorm and the ReLU after it."""
    return torch.relu(_bn(x, bn, dtype))


def _bn_train(x, bn, dtype, mesh=None):
    """flax's train-mode BatchNorm: batch statistics in float32 (mean and
    the fast biased variance), running statistics updated in place, the
    normalization in float32 and cast back.  The law that tests and
    scripts/torch_roofline_bwd.py hold the train step's ``bn_relu_train``
    (ops/bn_relu.py) to.

    Under a data mesh (parallel/mesh.py) the per-channel means and means
    of squares are averaged over the ranks (a differentiable sum over N)
    before the variance is read, so both are the GLOBAL batch's, as
    flax's BatchNorm over a sharded batch is (every rank holds as many
    rows); the running statistics then stay identical on every rank.  A
    mesh of one rank leaves the statistics' bits as they are."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    sq = (xf * xf).mean(dim=(0, 2, 3))
    if mesh is not None:
        from ..parallel.mesh import all_reduce_sum
        mean, sq = all_reduce_sum(torch.stack([mean, sq]), mesh) / mesh.size
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean * (1 - BN_MOMENTUM))
        bn.running_var.mul_(BN_MOMENTUM).add_(var * (1 - BN_MOMENTUM))
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
    return (y + bn.bias.view(1, -1, 1, 1)).to(dtype)


def _reads(depth: int, x: int) -> tuple[int, int]:
    """The input columns ``[lo, hi]`` that output column ``x`` of a
    ``depth``-level U-Net of this module reads.

    Walk the interval through every path from the logits to the input:
    each 3x3 conv at a level widens it by one pixel of that level on each
    side (two convs per encoder and per decoder block), a 2x2/2
    transposed conv maps level-i pixels ``[L, R]`` to level-(i+1) pixels
    ``[L//2, R//2]``, and going back up through a 2x2/2 max pool
    level-(i+1) pixels ``[a, b]`` came from level-i pixels ``[2a, 2b+1]``.
    The pattern repeats every ``2**depth`` columns."""
    lo_all = hi_all = x
    for skip in range(depth):        # the path through level ``skip``
        lo = hi = x
        for _ in range(skip):        # decoder block, then upconv
            lo, hi = (lo - 2) // 2, (hi + 2) // 2
        lo, hi = lo - 2, hi + 2      # the (decoder or bottom) block
        if skip < depth - 1:         # the encoder block at ``skip``
            lo, hi = lo - 2, hi + 2
        for _ in range(skip):        # pool, then encoder block
            lo, hi = 2 * lo - 2, 2 * hi + 3
        lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    return lo_all, hi_all


def receptive_radius(depth: int) -> int:
    """How far (in input pixels, on either side) an output pixel of a
    ``depth``-level U-Net can see (``_reads``).  The floor and the pool's
    extra pixel fall on opposite sides, so the reach is less than the sum
    of every layer's one-sided growth (122 at depth 5): the worst column
    over a period reaches ``7 * 2**(depth-1) - 5`` pixels, 107 at depth
    5."""
    return max(max(x - lo, hi - x) for x in range(2 ** depth)
               for lo, hi in (_reads(depth, x),))


def slab_halo(depth: int) -> int:
    """The pings a slab range needs past each inner end when both ends
    are multiples of the pooling alignment ``p = 2**(depth-1)``, as
    ``runner._predict_slab``'s ranges are: the farthest any output column
    inside the range reads past the nearer end (``_reads``, over both
    phases of an end within the pattern's period), rounded up to ``p`` so
    the window keeps the global pooling grid.  The columns that reach
    ``receptive_radius`` sit deeper inside an aligned range than its
    edge, so the halo is smaller than the radius rounded up: 94 -> 96 px
    at depth 5 (the radius 107 -> 112), 22 -> 24 at depth 3."""
    p = 2 ** (depth - 1)
    span = receptive_radius(depth) + 1   # deeper columns read nothing past
    need = 0
    for end in (0, p):
        for x in range(end - span, end):     # left of a right end
            need = max(need, _reads(depth, x)[1] - end + 1)
        for x in range(end, end + span):     # right of a left end
            need = max(need, end - _reads(depth, x)[0])
    return -(-need // p) * p


def _nchw(t_nhwc):
    return t_nhwc.permute(0, 3, 1, 2)


def _nhwc(t_nchw):
    return t_nchw.permute(0, 2, 3, 1).contiguous()


def _norm(features: int, use_bn: bool) -> nn.Module:
    return nn.BatchNorm2d(features) if use_bn else nn.Identity()


class DownConv(nn.Module):
    """Two conv-BN-ReLU units (+ optional 2x2 maxpool)
    (reference unet.py:63-93)."""

    def __init__(self, in_channels, out_channels, pooling, use_bn):
        super().__init__()
        self.pooling = pooling
        self.use_bn = use_bn
        self.main = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            _norm(out_channels, use_bn), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
            _norm(out_channels, use_bn), nn.ReLU())

    def forward(self, x, dtype, pool_kernels: bool, bn_relu=_bn_relu):
        conv1, bn1, conv2, bn2 = (self.main[0], self.main[1], self.main[3],
                                  self.main[4])
        x = bn_relu(_conv(x, conv1, dtype), bn1, dtype)
        z = _conv(x, conv2, dtype)
        if pool_kernels and self.pooling and not self.use_bn:
            # BatchNorm folded into conv2: the kernel takes the raw output
            pooled, skip = relu_pool_skip(_nhwc(z))
            return _nchw(pooled), _nchw(skip)
        y = bn_relu(z, bn2, dtype)
        if not self.pooling:
            return y, y
        if pool_kernels:
            return _nchw(maxpool2x2(_nhwc(y))), y
        return F.max_pool2d(y, 2, 2), y


class UpConv(nn.Module):
    """Transpose-conv 2x2 upsample, skip concat, two conv-BN-ReLU units
    (reference unet.py:96-137)."""

    def __init__(self, in_channels, out_channels, use_bn):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(in_channels, out_channels, 2,
                                         stride=2)
        self.conv1 = nn.Conv2d(2 * out_channels, out_channels, 3, padding=1)
        self.bn1 = _norm(out_channels, use_bn)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn2 = _norm(out_channels, use_bn)

    def forward(self, from_down, from_up, dtype, bn_relu=_bn_relu):
        up = F.conv_transpose2d(from_up, self.upconv.weight.to(dtype), None,
                                stride=2)
        up = up + self.upconv.bias.to(dtype).view(1, -1, 1, 1)
        x = torch.cat([up, from_down], dim=1)
        x = bn_relu(_conv(x, self.conv1, dtype), self.bn1, dtype)
        return bn_relu(_conv(x, self.conv2, dtype), self.bn2, dtype)


class MetaPostProcessing(nn.Module):
    """Per-pixel MLP over the metadata channels, Linear 32 -> ReLU -> 32 ->
    ReLU -> ``out_features`` (reference unet.py:140-166; JAX
    ``models/unet.py`` ``MetaPostProcessing``).  NHWC in and out, so the
    Linear layers act on the channel axis directly.  Cast as flax's Dense:
    input and weight in the compute dtype, the bias added in it."""

    def __init__(self, in_features, out_features=1):
        super().__init__()
        self.main = nn.Sequential(
            nn.Linear(in_features, 32), nn.ReLU(), nn.Linear(32, 32),
            nn.ReLU(), nn.Linear(32, out_features))

    def forward(self, x, dtype):
        for i in (0, 2, 4):
            fc = self.main[i]
            x = F.linear(x.to(dtype), fc.weight.to(dtype)) + fc.bias.to(dtype)
            if i < 4:
                x = torch.relu(x)
        return x


class UNet(nn.Module):
    """U-Net encoder/decoder: NHWC in, NHWC float32 logits out; train mode
    (``model.train()``) runs with autograd and flax's BatchNorm, eval mode
    without autograd.  ``use_bn=False`` is the BatchNorm-folded serving
    form (models/fold_bn.py), eval only.  ``late_meta_inject`` adds the metadata MLP over
    ``meta_channels`` input channels; ``forward`` then takes ``meta``."""

    def __init__(self, n_classes=3, depth=5, start_filts=64, in_channels=4,
                 late_meta_inject=False, dtype=torch.float32, use_bn=True,
                 meta_channels=0):
        super().__init__()
        if late_meta_inject and meta_channels < 1:
            raise ValueError("late_meta_inject needs at least one metadata "
                             "channel (meta_channels)")
        self.hparams = dict(n_classes=n_classes, depth=depth,
                            start_filts=start_filts, in_channels=in_channels,
                            late_meta_inject=late_meta_inject, dtype=dtype,
                            use_bn=use_bn, meta_channels=meta_channels)
        self.late_meta_inject = late_meta_inject
        self.depth = depth
        self.dtype = dtype
        self.use_bn = use_bn
        self.down_convs = nn.ModuleList()
        outs = in_channels
        for i in range(depth):
            ins, outs = outs, start_filts * 2 ** i
            self.down_convs.append(DownConv(ins, outs, i < depth - 1, use_bn))
        self.up_convs = nn.ModuleList()
        for _ in range(depth - 1):
            ins, outs = outs, outs // 2
            self.up_convs.append(UpConv(ins, outs, use_bn))
        if late_meta_inject:
            self.post_processing_weights = MetaPostProcessing(meta_channels)
            outs += 1
        self.conv_final = nn.Conv2d(outs, n_classes, 1)

    @property
    def alignment(self) -> int:
        """What slab mode pads a chunk's grid to a multiple of: the
        ``depth - 1`` 2x2 pools' ``2**(depth-1)``."""
        return 2 ** (self.depth - 1)

    @property
    def halo(self) -> int:
        """Slab mode's ping-axis halo past a range's aligned ends
        (:func:`slab_halo`, 96 at depth 5)."""
        return slab_halo(self.depth)

    def forward(self, x, meta=None, mesh=None, gen=None):
        """``x`` (B, H, W, C) NHWC; ``meta`` (B, H, W, M) NHWC metadata for
        late inject (early inject concatenates it into ``x``); ``mesh``
        (train mode) the data mesh whose global batch the BatchNorm
        statistics are taken over (parallel/mesh.py); ``gen`` the train
        step's generator, which the U-Net, with no stochastic layer, does
        not draw from."""
        if self.late_meta_inject and meta is None:
            raise ValueError("late_meta_inject requires meta input")
        if not self.training:
            with torch.no_grad():
                return self._forward(x, meta, train=False)
        if not self.use_bn:
            # silently training a BN-folded model would corrupt the
            # folded statistics
            raise ValueError("BN-folded models are eval-only")
        return self._forward(x, meta, train=True, mesh=mesh)

    def _forward(self, x, meta, train: bool, mesh=None):
        bn_relu = _bn_relu
        if train:
            def bn_relu(y, bn, dtype):
                return bn_relu_train(y, bn, mesh)
        x = _nchw(x.contiguous()).to(self.dtype)  # channels_last NCHW view
        encoder_outs = []
        for i, down in enumerate(self.down_convs):
            x, before_pool = down(x, self.dtype,
                                  pool_kernels=i == 0 and not train,
                                  bn_relu=bn_relu)
            encoder_outs.append(before_pool)
        for i, up in enumerate(self.up_convs):
            x = up(encoder_outs[-(i + 2)], x, self.dtype, bn_relu=bn_relu)
        if self.late_meta_inject:
            m = self.post_processing_weights(meta, self.dtype)
            x = torch.cat([x, _nchw(m)], dim=1)
        return _nhwc(_conv(x, self.conv_final, self.dtype).float())


def build_unet(config: dict) -> UNet:
    """The flagship model from a merged config dict
    (reference SegPipeUNet, pipeline.py:379-410)."""
    from ..data.meta_channels import get_in_channels
    name = str(config.get("compute_dtype", "float32"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    n_meta = get_in_channels(config.get("meta_channels"))
    late = bool(config.get("late_meta_inject", False))
    n_freq = len(config.get("frequencies", (18, 38, 120, 200)))
    # early inject: the metadata bands follow the acoustic ones
    # (reference pipeline.py:413-425)
    return UNet(n_classes=3, depth=int(config.get("depth", 5)),
                start_filts=int(config.get("start_filts", 64)),
                in_channels=n_freq + (0 if late else n_meta),
                late_meta_inject=late, dtype=COMPUTE_DTYPES[name],
                meta_channels=n_meta if late else 0)


@torch.no_grad()
def init_random_(model: UNet, generator: torch.Generator) -> UNet:
    """Seeded random weights (smoke runs, tests): conv, transpose-conv and
    linear weights and biases U(+-1/sqrt(fan_in)) with torch's fan-in
    convention (weight.size(1) * kh * kw, for transpose convs too), and
    BatchNorm
    statistics and affine drawn around identity so folding is not a
    no-op."""
    def uniform_(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            b = fan_in ** -0.5
            uniform_(m.weight, -b, b)
            uniform_(m.bias, -b, b)
        elif isinstance(m, nn.BatchNorm2d):
            uniform_(m.weight, 0.5, 1.5)
            uniform_(m.bias, -0.1, 0.1)
            uniform_(m.running_mean, -0.1, 0.1)
            uniform_(m.running_var, 0.5, 1.5)
    return model


@torch.no_grad()
def init_train_(model: UNet, generator: torch.Generator) -> UNet:
    """torch's default initialisation from an explicit generator, as the
    reference trains from it (and the JAX package's initializers follow
    it): conv, transpose-conv and linear weights and biases
    U(+-1/sqrt(fan_in)) with torch's fan-in convention
    (``weight.size(1) * kh * kw``, for transpose convs too), BatchNorm
    scale 1, bias 0, running mean 0, running variance 1."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            b = m.weight[0].numel() ** -0.5
            for t in (m.weight, m.bias):
                t.copy_(torch.rand(t.shape, generator=generator) * (2 * b)
                        - b)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def count_params(params) -> int:
    """Number of scalars in ``params``: a module's parameters, or every
    leaf of a (nested) dict of arrays, as the JAX package counts its
    ``variables["params"]`` tree (a state dict's buffers count too)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return math.prod(params.shape)
