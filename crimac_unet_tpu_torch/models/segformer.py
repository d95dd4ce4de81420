"""SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203): the Mix
Transformer (MiT) encoder and the all-MLP decode head, for echogram
segmentation.

The preset is MiT-B2 as published (``nvidia/mit-b2``; mmsegmentation's
``segformer_mit-b2_8xb2-160k_ade20k-512x512.py``):

* four stages of hidden 64 / 128 / 320 / 512, depths 3 / 4 / 6 / 3, heads
  1 / 2 / 5 / 8 (head dim 64), spatial-reduction ratios 8 / 4 / 2 / 1,
  Mix-FFN ratio 4;
* overlapping patch embeddings: a conv of kernel 7 stride 4 padding 3,
  then kernel 3 stride 2 padding 1 three times, each followed by
  LayerNorm;
* a pre-norm block: ``x + drop_path(attn(LN(x)))``, then ``x +
  drop_path(ffn(LN(x)))``; the attention's keys and values come from a
  conv of kernel and stride ``sr`` over the stage's map and a LayerNorm
  over its tokens (``sr`` 1: the tokens themselves); the Mix-FFN is
  linear 4x -> depthwise 3x3 conv -> exact (erf) GELU -> linear; a
  LayerNorm ends every stage; LayerNorm eps 1e-6 (mmseg's MiT);
* the decode head: a linear layer a stage to 768 channels, bilinear
  upsampling (``align_corners=False``; as two interpolation-matrix
  products, :func:`upsample`) to the first stage's 1/4 map, the
  four concatenated deepest first (3072 channels), a 1x1 conv to 768 with
  no bias, BatchNorm, ReLU, dropout, a 1x1 classifier; the logits at 1/4
  are upsampled bilinearly to the input's size;
* drop-path rising linearly from 0 to 0.1 over the 16 blocks, decode
  dropout 0.1.

Departures, all of them the task's: ``len(frequencies)`` input channels
(4) and 3 classes.  Parameter names are Hugging Face's
``SegformerForSemanticSegmentation`` state-dict names, so published
weights map onto the model key for key where the shapes agree.

As the U-Net (models/unet.py): NHWC float32 dB in, NHWC float32 logits
out; float32 parameters, the conv and linear ones cast to the compute
``dtype`` once a forward (:class:`Cast`).  As mixed-precision training
keeps them: the residual stream and every LayerNorm in float32 (a
branch's ``dtype`` output is added back in float32), so that the
gradients of the norms and biases, sums over up to B x 16384 tokens that
largely cancel, are not summed from bfloat16 roundings; attention's
softmax runs in float32 (ops/attention.py); the train-mode BatchNorm +
ReLU of the decode head is ``bn_relu_train`` (ops/bn_relu.py: flax's
law, the global batch's statistics under a data mesh).  Drop-path and
dropout masks are drawn from the generator the train step passes in
(``gen``), for the global batch under a mesh and cut to this rank's rows,
as the augmentation's draws are; at rate 0 nothing is drawn.  ``use_bn=False`` is the serving
form with the BatchNorm folded into the fuse conv (models/fold_bn.py),
eval only.

SegFormer has no position embedding and attends over the whole window,
so every output pixel depends on every input pixel: it has no finite
slab halo (``halo`` None) and is served in patch mode.  ``alignment``
(32 for MiT) is what a window's sides must be multiples of for every
stride and spatial reduction to divide its stage's map.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import PairCounter, attention
from ..ops.bn_relu import bn_relu_train
from .unet import COMPUTE_DTYPES, _bn_relu

# nvidia/mit-b2 with the decode head's width and regularisers of the
# mmseg ADE20K recipe; keys are Hugging Face's SegformerConfig names
MIT_B2 = {
    "hidden_sizes": [64, 128, 320, 512],
    "depths": [3, 4, 6, 3],
    "num_attention_heads": [1, 2, 5, 8],
    "sr_ratios": [8, 4, 2, 1],
    "patch_sizes": [7, 3, 3, 3],
    "strides": [4, 2, 2, 2],
    "mlp_ratios": [4, 4, 4, 4],
    "decoder_hidden_size": 768,
    "layer_norm_eps": 1e-6,
    "drop_path_rate": 0.1,
    "classifier_dropout_prob": 0.1,
}


def _profiled(name):
    """A ``torch.profiler`` range around a block of the model, for traces
    that record the host's operators."""
    return torch.profiler.record_function(name)


class Cast:
    """The compute-``dtype`` copies of a forward's conv and linear weights
    and biases, made by one cast of their concatenation (a cast a tensor
    is ~520 more launches and autograd nodes a training step, and the
    step's host enqueue is what paces it); ``cast(p)`` is ``p``'s copy,
    ``p`` itself in float32."""

    def __init__(self, params, dtype):
        self.dtype = dtype
        self.copies = None
        if dtype != torch.float32:
            flat = torch.cat([p.reshape(-1) for p in params]).to(dtype)
            parts = flat.split([p.numel() for p in params])
            self.copies = {id(p): c.view(p.shape)
                           for p, c in zip(params, parts)}

    def __call__(self, p):
        if p is None or self.copies is None:
            return p
        return self.copies[id(p)]


def _linear(x, fc, cast):
    return F.linear(x, cast(fc.weight), cast(fc.bias))


def _conv(x, conv, cast):
    return F.conv2d(x, cast(conv.weight), cast(conv.bias), conv.stride,
                    conv.padding, groups=conv.groups)


def _layer_norm(x, ln):
    """LayerNorm in float32, whatever ``x``'s dtype; float32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _nchw(t, h, w):
    """(B, h*w, C) tokens -> their (B, C, h, w) channels_last view."""
    return t.view(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)


def _tokens(t):
    """(B, C, h, w) -> (B, h*w, C) tokens (a view of a channels_last
    map)."""
    B, C = t.shape[:2]
    return t.permute(0, 2, 3, 1).reshape(B, -1, C)


def resize_matrix(n_out, n_in, dtype, device):
    """The (n_out, n_in) weights of bilinear resizing along one axis with
    ``align_corners=False``, PyTorch's law: output ``i`` reads input
    ``s = max((i + 0.5) * n_in / n_out - 0.5, 0)`` as ``(1 - f) x[i0] +
    f x[i0 + 1]``, ``i0 = floor(s)``, ``f = s - i0``, the last input
    repeated past the end.  At the decode head's power-of-two factors
    every weight is a multiple of 1/16, exact in bfloat16."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
           - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = src - i0
    a = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    a.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    a.index_put_((rows, i1), frac, accumulate=True)
    return a.to(device=device, dtype=dtype)


def upsample(y, size, cache=None):
    """Bilinear resizing (``align_corners=False``) of the (B, h, w, C)
    map ``y`` to (B, H, W, C), as two products with :func:`resize_matrix`
    weights, rows then columns, accumulated in float32 by the matrix
    units; their gradients are products too.  The same map as
    ``F.interpolate(..., mode="bilinear")``, whose bfloat16 NHWC backward
    sums a pixel's gradient by atomic adds in bfloat16 (up to 1.9 %
    relative error at the decode head's 8x, measured on the H100) and
    took a fifth of a training step's device time.  ``cache`` (a dict)
    keeps the weights on the device: made anew, each is a copy from the
    host, which waits for the device's queue."""
    B, h, w, C = y.shape
    H, W = size
    cache = {} if cache is None else cache
    mats = []
    for n_out, n_in in ((H, h), (W, w)):
        key = (n_out, n_in, y.dtype, y.device)
        if key not in cache:
            cache[key] = resize_matrix(n_out, n_in, y.dtype, y.device)
        mats.append(cache[key])
    rows, cols = mats
    t = torch.bmm(rows.expand(B, H, h), y.reshape(B, h, w * C))
    return torch.bmm(cols.expand(B * H, W, w),
                     t.view(B * H, w, C)).view(B, H, W, C)


class Draws:
    """The train step's stochastic layers: drop-path and dropout masks
    drawn from ``gen`` for the global batch of a ``shard=(rank, n)``
    mesh and cut to this rank's rows."""

    def __init__(self, gen, shard=None):
        self.gen = gen
        self.rank, self.n = shard or (0, 1)

    def _keep(self, shape, p, device):
        b = shape[0]
        u = torch.rand((b * self.n,) + tuple(shape[1:]), generator=self.gen,
                       device=device)
        return u[self.rank * b:(self.rank + 1) * b] >= p

    def drop_path(self, x, p):
        """Whole samples of the residual branch ``x`` dropped with
        probability ``p``, the rest scaled by ``1 / (1 - p)``."""
        if p <= 0.0:
            return x
        keep = self._keep((x.shape[0],), p, x.device)
        scale = keep.to(x.dtype) / (1.0 - p)
        return x * scale.view((-1,) + (1,) * (x.dim() - 1))

    def dropout(self, x, p):
        """Elements of the (B, C, H, W) channels_last map ``x`` dropped
        with probability ``p``, the rest scaled by ``1 / (1 - p)``."""
        if p <= 0.0:
            return x
        nhwc = x.permute(0, 2, 3, 1)
        keep = self._keep(nhwc.shape, p, x.device).permute(0, 3, 1, 2)
        return x * (keep.to(x.dtype) / (1.0 - p))


class OverlapPatchEmbeddings(nn.Module):
    def __init__(self, patch_size, stride, in_channels, hidden, eps):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden, patch_size, stride,
                              patch_size // 2)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x, cast):
        """(B, C, H, W) -> ((B, h*w, hidden) float32 tokens, h, w)."""
        y = _conv(x, self.proj, cast)
        h, w = y.shape[2:]
        return _layer_norm(_tokens(y), self.layer_norm), h, w


class EfficientSelfAttention(nn.Module):
    def __init__(self, hidden, heads, sr_ratio, eps):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(hidden, hidden, sr_ratio, sr_ratio)
            self.layer_norm = nn.LayerNorm(hidden, eps=eps)

    def _heads(self, t):
        B, N, C = t.shape
        return t.view(B, N, self.heads, C // self.heads).transpose(1, 2)

    def forward(self, x, h, w, cast, counter):
        q = self._heads(_linear(x, self.query, cast))
        kv = x
        if self.sr_ratio > 1:
            kv = _tokens(_conv(_nchw(x, h, w), self.sr, cast))
            kv = _layer_norm(kv, self.layer_norm).to(cast.dtype)
        k = self._heads(_linear(kv, self.key, cast))
        v = self._heads(_linear(kv, self.value, cast))
        ctx = attention(q, k, v, counter)
        return ctx.transpose(1, 2).reshape(x.shape)


class SelfOutput(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


class Attention(nn.Module):
    def __init__(self, hidden, heads, sr_ratio, eps):
        super().__init__()
        self.self = EfficientSelfAttention(hidden, heads, sr_ratio, eps)
        self.output = SelfOutput(hidden)

    def forward(self, x, h, w, cast, counter):
        with _profiled("segformer.attention"):
            ctx = self.self(x, h, w, cast, counter)
            return _linear(ctx, self.output.dense, cast)


class DWConv(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.dwconv = nn.Conv2d(channels, channels, 3, 1, 1,
                                groups=channels)


class MixFFN(nn.Module):
    def __init__(self, hidden, ratio):
        super().__init__()
        inner = hidden * ratio
        self.dense1 = nn.Linear(hidden, inner)
        self.dwconv = DWConv(inner)
        self.dense2 = nn.Linear(inner, hidden)

    def forward(self, x, h, w, cast):
        with _profiled("segformer.mix_ffn"):
            y = _linear(x, self.dense1, cast)
            y = _tokens(_conv(_nchw(y, h, w), self.dwconv.dwconv, cast))
            return _linear(F.gelu(y), self.dense2, cast)


class Layer(nn.Module):
    """One pre-norm MiT block."""

    def __init__(self, hidden, heads, sr_ratio, ratio, drop_path, eps):
        super().__init__()
        self.drop_path = drop_path
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=eps)
        self.attention = Attention(hidden, heads, sr_ratio, eps)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = MixFFN(hidden, ratio)

    def forward(self, x, h, w, cast, counter, draws):
        """``x`` the float32 residual stream; the branches compute in
        ``cast.dtype`` and are added back in float32."""
        a = self.attention(_layer_norm(x, self.layer_norm_1).to(cast.dtype),
                           h, w, cast, counter)
        if draws is not None:
            a = draws.drop_path(a, self.drop_path)
        x = x + a
        m = self.mlp(_layer_norm(x, self.layer_norm_2).to(cast.dtype), h, w,
                     cast)
        if draws is not None:
            m = draws.drop_path(m, self.drop_path)
        return x + m


class Encoder(nn.Module):
    def __init__(self, in_channels, hp):
        super().__init__()
        eps = hp["layer_norm_eps"]
        rates = torch.linspace(0, hp["drop_path_rate"],
                               sum(hp["depths"])).tolist()
        self.patch_embeddings = nn.ModuleList()
        self.block = nn.ModuleList()
        self.layer_norm = nn.ModuleList()
        cin, i = in_channels, 0
        for s, hidden in enumerate(hp["hidden_sizes"]):
            self.patch_embeddings.append(OverlapPatchEmbeddings(
                hp["patch_sizes"][s], hp["strides"][s], cin, hidden, eps))
            self.block.append(nn.ModuleList(
                Layer(hidden, hp["num_attention_heads"][s],
                      hp["sr_ratios"][s], hp["mlp_ratios"][s], rates[i + j],
                      eps) for j in range(hp["depths"][s])))
            self.layer_norm.append(nn.LayerNorm(hidden, eps=eps))
            cin, i = hidden, i + hp["depths"][s]

    def forward(self, x, cast, counter, draws):
        """(B, C, H, W) channels_last -> the four stages' (B, h, w, C)
        maps."""
        outs = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            with _profiled("segformer.patch_embed"):
                t, h, w = embed(x, cast)
            for layer in blocks:
                t = layer(t, h, w, cast, counter, draws)
            t = _layer_norm(t, norm).to(cast.dtype)
            outs.append(t.view(t.shape[0], h, w, t.shape[-1]))
            x = outs[-1].permute(0, 3, 1, 2)
        return outs


class MLP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class DecodeHead(nn.Module):
    def __init__(self, hidden_sizes, width, n_classes, dropout, use_bn):
        super().__init__()
        self.dropout = dropout
        self.linear_c = nn.ModuleList(MLP(c, width) for c in hidden_sizes)
        self.linear_fuse = nn.Conv2d(width * len(hidden_sizes), width, 1,
                                     bias=not use_bn)
        self.batch_norm = nn.BatchNorm2d(width) if use_bn else nn.Identity()
        self.classifier = nn.Conv2d(width, n_classes, 1)
        self.resize_cache: dict = {}

    def forward(self, feats, cast, train, mesh, draws):
        """The stages' (B, h, w, C) maps -> (B, n_classes, H/4, W/4)
        logits in ``cast.dtype``."""
        size = feats[0].shape[1:3]
        ups = []
        for f, mlp in zip(feats, self.linear_c):
            y = _linear(f, mlp.proj, cast)
            if y.shape[1:3] != size:
                y = upsample(y, size, self.resize_cache)
            ups.append(y.permute(0, 3, 1, 2))
        z = _conv(torch.cat(ups[::-1], dim=1), self.linear_fuse, cast)
        if train:
            z = bn_relu_train(z, self.batch_norm, mesh)
            if draws is not None:
                z = draws.dropout(z, self.dropout)
        else:
            z = _bn_relu(z, self.batch_norm, cast.dtype)
        return _conv(z, self.classifier, cast)


class SegFormer(nn.Module):
    """SegFormer: NHWC in, NHWC float32 logits at the input's size out;
    train mode (``model.train()``) with autograd, eval mode without."""

    def __init__(self, n_classes=3, in_channels=4, dtype=torch.float32,
                 use_bn=True, **arch):
        super().__init__()
        hp = dict(MIT_B2, **arch)
        unknown = set(hp) - set(MIT_B2)
        if unknown:
            raise ValueError(f"SegFormer has no setting {sorted(unknown)}")
        for k in ("hidden_sizes", "num_attention_heads", "sr_ratios",
                  "patch_sizes", "strides", "mlp_ratios"):
            if len(hp[k]) != len(hp["depths"]):
                raise ValueError(f"SegFormer's {k} has {len(hp[k])} "
                                 f"stages, depths {len(hp['depths'])}")
        for c, heads in zip(hp["hidden_sizes"], hp["num_attention_heads"]):
            if c % heads:
                raise ValueError(f"{heads} heads do not divide hidden {c}")
        self.hparams = dict(hp, n_classes=n_classes, in_channels=in_channels,
                            dtype=dtype, use_bn=use_bn)
        self.dtype = dtype
        self.use_bn = use_bn
        self.segformer = nn.Module()
        self.segformer.encoder = Encoder(in_channels, hp)
        self.decode_head = DecodeHead(hp["hidden_sizes"],
                                      hp["decoder_hidden_size"], n_classes,
                                      hp["classifier_dropout_prob"], use_bn)
        self.counter = PairCounter()
        reach, self.alignment = 1, 1
        for stride, sr in zip(hp["strides"], hp["sr_ratios"]):
            reach *= stride
            self.alignment = max(self.alignment, reach * sr)
        # attention reaches the whole window: no slab halo
        self.halo = None

    def forward(self, x, meta=None, mesh=None, gen=None):
        """``x`` (B, H, W, C) NHWC float32 dB; ``mesh`` (train mode) the
        data mesh; ``gen`` (train mode) the generator of the drop-path and
        dropout masks (None: none drawn, as at rate 0).  ``meta`` must be
        None: SegFormer takes no metadata channels."""
        if meta is not None:
            raise ValueError("SegFormer takes no metadata input")
        if not self.training:
            with torch.no_grad():
                return self._forward(x, train=False)
        if not self.use_bn:
            raise ValueError("BN-folded models are eval-only")
        draws = None
        if gen is not None:
            draws = Draws(gen, None if mesh is None
                          else (mesh.rank, mesh.size))
        return self._forward(x, train=True, mesh=mesh, draws=draws)

    def _forward(self, x, train, mesh=None, draws=None):
        H, W = x.shape[1:3]
        x = x.contiguous().permute(0, 3, 1, 2).to(self.dtype)
        cast = Cast(self._cast_params(), self.dtype)
        feats = self.segformer.encoder(x, cast, self.counter, draws)
        with _profiled("segformer.decode_head"):
            logits = self.decode_head(feats, cast, train, mesh, draws)
            logits = F.interpolate(logits.float(), size=(H, W),
                                   mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1).contiguous()

    def _cast_params(self):
        """The conv and linear weights and biases, in module order."""
        return [p for m in self.modules()
                if isinstance(m, (nn.Linear, nn.Conv2d))
                for p in (m.weight, m.bias) if p is not None]

    @property
    def stochastic(self) -> bool:
        """Whether a training forward draws masks (a drop-path or dropout
        rate above 0)."""
        return self.decode_head.dropout > 0 or any(
            layer.drop_path > 0 for blocks in self.segformer.encoder.block
            for layer in blocks)

    def take_attn_pairs(self) -> int:
        """``attn_pairs``: the query-key pairs (B * heads * N_q * N_kv)
        the attention calls scored since this was last taken; a training
        step's count times ``12 * head_dim`` is its attention FLOPs.  A
        host count: under a train step's CUDA graph (``train_graph``) it
        counts the capture's forwards, not the replays."""
        return self.counter.take()


def build_segformer(config: dict) -> SegFormer:
    """The SegFormer of a merged config dict: ``MIT_B2`` with the keys the
    config sets, ``len(frequencies)`` input channels, 3 classes."""
    from ..data.meta_channels import get_in_channels
    if get_in_channels(config.get("meta_channels")) > 0 \
            or config.get("late_meta_inject"):
        raise ValueError("meta_channels and late_meta_inject are U-Net "
                         "settings: SegFormer takes the acoustic channels "
                         "alone")
    name = str(config.get("compute_dtype", "float32"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    arch = {k: config[k] for k in MIT_B2 if k in config}
    n_freq = len(config.get("frequencies", (18, 38, 120, 200)))
    return SegFormer(n_classes=3, in_channels=n_freq,
                     dtype=COMPUTE_DTYPES[name], **arch)


def _trunc_normal_(t, std, gen):
    """N(0, std) cut at +-2 std, by redrawing, as ``trunc_normal_``."""
    out = torch.randn(t.shape, generator=gen)
    bad = out.abs() > 2.0
    while bad.any():
        out[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = out.abs() > 2.0
    t.copy_(out * std)


@torch.no_grad()
def init_train_(model: SegFormer, generator: torch.Generator) -> SegFormer:
    """SegFormer's published initialisation from an explicit generator
    (the NVlabs and mmseg MiT ``init_weights``): linear weights truncated
    normal, std 0.02, biases 0; conv weights normal, std
    ``sqrt(2 / fan_out)`` with ``fan_out = k * k * out / groups``, biases
    0; LayerNorm and BatchNorm scale 1, bias 0, running statistics 0 / 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, 0.02, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            fan_out = kh * kw * m.out_channels // m.groups
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_out))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    return model

