"""The plain SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203): the
MiT encoder and the all-MLP decode head, as the paper, the NVlabs code and
the ``nvidia/mit-b2`` configuration give them.  NCHW float32, functional
over a state dict keyed by Hugging Face's ``SegformerForSemanticSegmentation``
names (the program's), so the same tensors load into the program.

The layer equations, a stage ``s`` of hidden ``C``, ``heads`` heads of
``d = C / heads``, reduction ``sr``:

* patch embedding: ``t = LN(conv(x, k, stride, k // 2))`` as tokens;
* a block: ``t = t + drop_path(O(A(LN1(t))))``, ``t = t + drop_path(
  W2(GELU(DW(W1(LN2(t))))))``; ``A``: ``q = Wq u``, ``kv = LN_sr(conv_sr(
  u))`` (``sr`` > 1, kernel and stride ``sr`` over the stage's map; else
  ``kv = u``), ``k = Wk kv``, ``v = Wv kv``, ``softmax(q k^T / sqrt(d))
  v`` a head; ``DW`` a depthwise 3x3 conv (padding 1) over the map; GELU
  exact (erf); a LayerNorm ends the stage; LayerNorm eps 1e-6 (mmseg's
  MiT);
* decode head: ``u_s = up(L_s(f_s))`` to the first stage's map (bilinear,
  ``align_corners=False``), ``z = ReLU(BN(conv1x1(cat(u_4, u_3, u_2,
  u_1))))`` (no conv bias), dropout, ``logits = conv1x1(z)``, upsampled
  bilinearly to the input's size.

Departures, each the task's or the benchmark's: ``in_channels`` (the
survey's 4 frequencies, not RGB) and 3 classes; drop-path and dropout are
not drawn (the benchmark's configuration sets both rates to 0, and a mask
drawn by one side only would part the program from the reference);
BatchNorm as the program has it, flax's (biased batch variance in train
mode, eps 1e-5).

``mode``: ``"eval"`` (running statistics), ``"train"`` (batch
statistics, gradients through them) or ``"calibrate"`` (the decode head's
BatchNorm's batch statistics written into its running ones).
``quant="fp8"`` is the control: the input and weight of every conv and
linear rounded to float8 e4m3 (per-tensor scale to the format's largest
value) before a float32 product, gradients straight through; the step
below the bfloat16 the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import exact_float32

BN_EPS = 1e-5
FP8_MAX = 448.0
ENC = "segformer.encoder"
HEAD = "decode_head"
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
}


def arch_of(cfg):
    """The MiT settings of a configuration (MiT-B2's where it sets
    none)."""
    return {k: cfg.get(k, v) for k, v in MIT_B2.items()}


def layout(arch, in_channels=4, n_classes=3):
    """[(name, shape, kind)] of every tensor in forward order; kind is
    'linear', 'conv', 'head', 'bias', 'norm_w', 'norm_b', 'mean', 'var'
    or 'count'."""
    out = []

    def lin(p, cin, cout):
        out.extend([(f"{p}.weight", (cout, cin), "linear"),
                    (f"{p}.bias", (cout,), "bias")])

    def conv(p, cin, cout, k, groups=1, bias=True, kind="conv"):
        out.append((f"{p}.weight", (cout, cin // groups, k, k), kind))
        if bias:
            out.append((f"{p}.bias", (cout,), "bias"))

    def norm(p, c):
        out.extend([(f"{p}.weight", (c,), "norm_w"),
                    (f"{p}.bias", (c,), "norm_b")])

    cin = in_channels
    for s, c in enumerate(arch["hidden_sizes"]):
        e = f"{ENC}.patch_embeddings.{s}"
        conv(f"{e}.proj", cin, c, arch["patch_sizes"][s])
        norm(f"{e}.layer_norm", c)
        inner = c * arch["mlp_ratios"][s]
        for j in range(arch["depths"][s]):
            b = f"{ENC}.block.{s}.{j}"
            a = f"{b}.attention.self"
            norm(f"{b}.layer_norm_1", c)
            lin(f"{a}.query", c, c)
            lin(f"{a}.key", c, c)
            lin(f"{a}.value", c, c)
            if arch["sr_ratios"][s] > 1:
                conv(f"{a}.sr", c, c, arch["sr_ratios"][s])
                norm(f"{a}.layer_norm", c)
            lin(f"{b}.attention.output.dense", c, c)
            norm(f"{b}.layer_norm_2", c)
            lin(f"{b}.mlp.dense1", c, inner)
            conv(f"{b}.mlp.dwconv.dwconv", inner, inner, 3, groups=inner)
            lin(f"{b}.mlp.dense2", inner, c)
        norm(f"{ENC}.layer_norm.{s}", c)
        cin = c
    width = arch["decoder_hidden_size"]
    for s, c in enumerate(arch["hidden_sizes"]):
        lin(f"{HEAD}.linear_c.{s}.proj", c, width)
    conv(f"{HEAD}.linear_fuse", width * len(arch["hidden_sizes"]), width, 1,
         bias=False)
    bn = f"{HEAD}.batch_norm"
    norm(bn, width)
    out.extend([(f"{bn}.running_mean", (width,), "mean"),
                (f"{bn}.running_var", (width,), "var"),
                (f"{bn}.num_batches_tracked", (), "count")])
    conv(f"{HEAD}.classifier", width, n_classes, 1, kind="head")
    return out


def init_state(gen, device, arch, in_channels=4, n_classes=3):
    """Seeded weights drawn on ``device``: linear weights N(0, 0.02) (the
    published std), conv weights N(0, 2 / fan_out) with ``fan_out = k * k
    * out / groups`` (the published law), the classifier's N(0, 1 /
    fan_in) (logits of about unit scale); biases U(-0.05, 0.05), every
    norm's scale U(0.8, 1.2) and shift U(-0.1, 0.1), so no parameter sits
    at a symmetric value; BatchNorm running statistics 0 / 1 until
    :func:`calibrate_bn`."""
    state = {}
    for name, shape, kind in layout(arch, in_channels, n_classes):
        def u(lo, hi):
            return torch.rand(shape, generator=gen, device=device) \
                * (hi - lo) + lo
        if kind in ("linear", "conv", "head"):
            w = torch.randn(shape, generator=gen, device=device)
            if kind == "linear":
                std = 0.02
            elif kind == "conv":
                std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            else:
                std = math.sqrt(1.0 / math.prod(shape[1:]))
            state[name] = w * std
        elif kind == "bias":
            state[name] = u(-0.05, 0.05)
        elif kind == "norm_w":
            state[name] = u(0.8, 1.2)
        elif kind == "norm_b":
            state[name] = u(-0.1, 0.1)
        elif kind == "mean":
            state[name] = torch.zeros(shape, device=device)
        elif kind == "var":
            state[name] = torch.ones(shape, device=device)
        else:
            state[name] = torch.zeros(shape, dtype=torch.int64,
                                      device=device)
    return state


def _fp8(t):
    """Round to float8 e4m3 with a per-tensor scale, back to float32;
    gradients pass the rounding unchanged (straight through)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return t + (q - t.detach())


class _Net:
    def __init__(self, state, arch, quant, mode):
        self.s, self.arch, self.quant, self.mode = state, arch, quant, mode
        self.eps = arch["layer_norm_eps"]

    def _q(self, x, w):
        if self.quant == "fp8":
            return _fp8(x), _fp8(w)
        return x, w

    def linear(self, t, p):
        """(..., cin) -> (..., cout)."""
        x, w = self._q(t, self.s[f"{p}.weight"])
        return x @ w.t() + self.s[f"{p}.bias"]

    def conv(self, x, p, stride=1, padding=0, groups=1):
        x, w = self._q(x, self.s[f"{p}.weight"])
        return F.conv2d(x, w, self.s.get(f"{p}.bias"), stride, padding,
                        groups=groups)

    def ln(self, t, p):
        mean = t.mean(-1, keepdim=True)
        var = ((t - mean) ** 2).mean(-1, keepdim=True)
        return (t - mean) / torch.sqrt(var + self.eps) \
            * self.s[f"{p}.weight"] + self.s[f"{p}.bias"]

    def bn(self, x, p):
        g, b = self.s[f"{p}.weight"], self.s[f"{p}.bias"]
        if self.mode == "eval":
            mean = self.s[f"{p}.running_mean"]
            var = self.s[f"{p}.running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.mode == "calibrate":
                self.s[f"{p}.running_mean"] = mean.detach().clone()
                self.s[f"{p}.running_var"] = var.detach().clone()
        mul = g / torch.sqrt(var + BN_EPS)
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + b[None, :, None, None]

    @staticmethod
    def tokens(x):
        """(B, C, h, w) -> (B, h*w, C)."""
        return x.flatten(2).transpose(1, 2)

    @staticmethod
    def grid(t, h, w):
        """(B, h*w, C) -> (B, C, h, w)."""
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)

    def attention(self, u, h, w, p, heads, sr):
        B, N, C = u.shape
        d = C // heads
        a = f"{p}.attention.self"
        kv = u
        if sr > 1:
            kv = self.tokens(self.conv(self.grid(u, h, w), f"{a}.sr",
                                       stride=sr))
            kv = self.ln(kv, f"{a}.layer_norm")

        def split(t):
            return t.reshape(B, -1, heads, d).transpose(1, 2)

        q = split(self.linear(u, f"{a}.query"))
        k = split(self.linear(kv, f"{a}.key"))
        v = split(self.linear(kv, f"{a}.value"))
        scores = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), -1)
        ctx = (scores @ v).transpose(1, 2).reshape(B, N, C)
        return self.linear(ctx, f"{p}.attention.output.dense")

    def mix_ffn(self, u, h, w, p):
        y = self.linear(u, f"{p}.mlp.dense1")
        y = self.conv(self.grid(y, h, w), f"{p}.mlp.dwconv.dwconv",
                      padding=1, groups=y.shape[-1])
        return self.linear(F.gelu(self.tokens(y)), f"{p}.mlp.dense2")

    def __call__(self, x):
        arch = self.arch
        feats = []
        for s in range(len(arch["hidden_sizes"])):
            e = f"{ENC}.patch_embeddings.{s}"
            k = arch["patch_sizes"][s]
            y = self.conv(x, f"{e}.proj", stride=arch["strides"][s],
                          padding=k // 2)
            h, w = y.shape[2:]
            t = self.ln(self.tokens(y), f"{e}.layer_norm")
            for j in range(arch["depths"][s]):
                p = f"{ENC}.block.{s}.{j}"
                t = t + self.attention(self.ln(t, f"{p}.layer_norm_1"), h, w,
                                       p, arch["num_attention_heads"][s],
                                       arch["sr_ratios"][s])
                t = t + self.mix_ffn(self.ln(t, f"{p}.layer_norm_2"), h, w, p)
            x = self.grid(self.ln(t, f"{ENC}.layer_norm.{s}"), h, w)
            feats.append(x)
        size = feats[0].shape[2:]
        ups = []
        for s, f in enumerate(feats):
            y = self.grid(self.linear(self.tokens(f),
                                      f"{HEAD}.linear_c.{s}.proj"),
                          *f.shape[2:])
            ups.append(F.interpolate(y, size=size, mode="bilinear",
                                     align_corners=False))
        z = self.conv(torch.cat(ups[::-1], dim=1), f"{HEAD}.linear_fuse")
        z = torch.relu(self.bn(z, f"{HEAD}.batch_norm"))
        logits = self.conv(z, f"{HEAD}.classifier")
        return F.interpolate(logits, size=self.in_size, mode="bilinear",
                             align_corners=False)


def forward(state, x, arch, quant=None, mode="eval"):
    """(B, C, H, W) float32 dB input -> (B, n_classes, H, W) logits."""
    net = _Net(state, arch, quant, mode)
    net.in_size = x.shape[2:]
    return net(x)


@torch.no_grad()
def calibrate_bn(state, x, arch):
    """Set the decode head's BatchNorm's running statistics to its batch
    statistics on ``x`` (crops of the survey), so that an eval-mode
    forward normalises the fuse conv's output as training would: with
    running statistics 0 / 1 the head's ReLU would pass its raw,
    offset output."""
    with exact_float32():
        forward(state, x, arch, mode="calibrate")
    return state
