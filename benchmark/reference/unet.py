"""The plain U-Net of CRIMAC-classifiers-unet (crimac_unet/models/unet.py):
``depth`` levels of two 3x3 conv-BN-ReLU units with 2x2 max pools
between them, 2x2 stride-2 transposed convs up, the skip concatenated
after the upsampled map, and a 1x1 head.  NCHW float32, functional over a
state dict keyed by the reference's parameter names, so the same tensors
load into the program.

``quant="fp8"`` is the control: every convolution's input and weight
rounded to float8 e4m3 (per-tensor scale to the format's largest value)
before a float32 convolution, the step below the bfloat16 the
configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import exact_float32

BN_EPS = 1e-5
FP8_MAX = 448.0
FIRST_BN = "down_convs.0.main.1"


def layout(depth=5, start_filts=64, in_channels=4, n_classes=3):
    """[(prefix, kind, cin, cout)] in forward order; kind is 'conv3',
    'bn', 'up' or 'head'."""
    out = []
    cin = in_channels
    for i in range(depth):
        cout = start_filts * 2 ** i
        p = f"down_convs.{i}.main"
        out += [(f"{p}.0", "conv3", cin, cout), (f"{p}.1", "bn", cout, cout),
                (f"{p}.3", "conv3", cout, cout), (f"{p}.4", "bn", cout, cout)]
        cin = cout
    for i in range(depth - 1):
        cout = cin // 2
        p = f"up_convs.{i}"
        out += [(f"{p}.upconv", "up", cin, cout),
                (f"{p}.conv1", "conv3", 2 * cout, cout),
                (f"{p}.bn1", "bn", cout, cout),
                (f"{p}.conv2", "conv3", cout, cout),
                (f"{p}.bn2", "bn", cout, cout)]
        cin = cout
    out.append(("conv_final", "head", cin, n_classes))
    return out


def _wshape(kind, cin, cout):
    return {"conv3": (cout, cin, 3, 3), "up": (cin, cout, 2, 2),
            "head": (cout, cin, 1, 1)}[kind]


def init_state(gen, device, depth=5, start_filts=64, in_channels=4,
               n_classes=3):
    """Seeded weights in a few large draws on ``device``: conv weights
    He-normal (std sqrt(2 / fan_in)), the head's sqrt(1 / fan_in), biases
    U(-0.05, 0.05), BatchNorm scale U(0.8, 1.2) and shift U(-0.1, 0.1);
    running statistics 0 / 1 until :func:`calibrate_bn`."""
    lay = layout(depth, start_filts, in_channels, n_classes)
    convs = [(p, k, ci, co) for p, k, ci, co in lay if k != "bn"]
    bns = [(p, co) for p, k, ci, co in lay if k == "bn"]
    n_w = sum(math.prod(_wshape(k, ci, co)) for _, k, ci, co in convs)
    n_b = sum(co for _, _, _, co in convs)
    n_bn = sum(co for _, co in bns)
    w_all = torch.randn(n_w, generator=gen, device=device)
    b_all = torch.rand(n_b, generator=gen, device=device) * 0.1 - 0.05
    g_all = torch.rand(n_bn, generator=gen, device=device) * 0.4 + 0.8
    s_all = torch.rand(n_bn, generator=gen, device=device) * 0.2 - 0.1
    state, iw, ib = {}, 0, 0
    for p, k, ci, co in convs:
        shp = _wshape(k, ci, co)
        n = math.prod(shp)
        fan_in = shp[1] * shp[2] * shp[3]
        std = math.sqrt((1.0 if k == "head" else 2.0) / fan_in)
        state[f"{p}.weight"] = (w_all[iw:iw + n] * std).view(shp)
        state[f"{p}.bias"] = b_all[ib:ib + co].clone()
        iw, ib = iw + n, ib + co
    i = 0
    for p, co in bns:
        state[f"{p}.weight"] = g_all[i:i + co].clone()
        state[f"{p}.bias"] = s_all[i:i + co].clone()
        state[f"{p}.running_mean"] = torch.zeros(co, device=device)
        state[f"{p}.running_var"] = torch.ones(co, device=device)
        state[f"{p}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
        i += co
    return state


def _fp8(t):
    """Round to float8 e4m3 with a per-tensor scale, back to float32;
    gradients pass the rounding unchanged (straight through), as in
    low-precision training."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return t + (q - t.detach())


class _Net:
    def __init__(self, state, depth, quant, bn_mode):
        self.s, self.depth, self.quant = state, depth, quant
        # 'eval': running statistics; 'train': batch statistics (biased
        # variance), gradients through them; 'calibrate': the first
        # BatchNorm's batch statistics written into its running ones
        self.bn_mode = bn_mode

    def conv(self, x, p, stride_up=False):
        w, b = self.s[f"{p}.weight"], self.s[f"{p}.bias"]
        if self.quant == "fp8":
            x, w = _fp8(x), _fp8(w)
        if stride_up:
            return F.conv_transpose2d(x, w, b, stride=2)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def bn(self, x, p):
        g, b = self.s[f"{p}.weight"], self.s[f"{p}.bias"]
        if self.bn_mode == "eval" or (self.bn_mode == "calibrate"
                                      and p != FIRST_BN):
            mean = self.s[f"{p}.running_mean"]
            var = self.s[f"{p}.running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.bn_mode == "calibrate":
                self.s[f"{p}.running_mean"] = mean.detach().clone()
                self.s[f"{p}.running_var"] = var.detach().clone()
        mul = g / torch.sqrt(var + BN_EPS)
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + b[None, :, None, None]

    def unit(self, x, conv, bn):
        return torch.relu(self.bn(self.conv(x, conv), bn))

    def __call__(self, x):
        skips = []
        for i in range(self.depth):
            p = f"down_convs.{i}.main"
            x = self.unit(self.unit(x, f"{p}.0", f"{p}.1"), f"{p}.3",
                          f"{p}.4")
            skips.append(x)
            if i < self.depth - 1:
                x = F.max_pool2d(x, 2, 2)
        for i in range(self.depth - 1):
            p = f"up_convs.{i}"
            up = self.conv(x, f"{p}.upconv", stride_up=True)
            x = torch.cat([up, skips[-(i + 2)]], dim=1)
            x = self.unit(self.unit(x, f"{p}.conv1", f"{p}.bn1"),
                          f"{p}.conv2", f"{p}.bn2")
        return self.conv(x, "conv_final")


def forward(state, x, depth=5, quant=None, bn_mode="eval"):
    """(B, C, H, W) float32 dB input -> (B, n_classes, H, W) logits."""
    return _Net(state, depth, quant, bn_mode)(x)


@torch.no_grad()
def calibrate_bn(state, x, depth=5):
    """Set the first BatchNorm's running statistics to its batch
    statistics on ``x``.  The survey's dB input sits mostly on the -75 dB
    floor, so the first convolution's output is large and offset; with it
    normalised, the He-scaled layers after it keep unit-scale
    activations, and the logits vary by about one unit over the survey,
    as trained weights' do.  The later BatchNorms keep running
    statistics 0 / 1: calibrating every layer makes a random network
    chaotic (a rounding at the input moves its output by ~15x as much),
    and the check could then not tell bfloat16 from fp8 apart."""
    with exact_float32():
        forward(state, x, depth, bn_mode="calibrate")
    return state
