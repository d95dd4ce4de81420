"""SegFormer MiT-B2 (``benchmark/reference/segformer.py``; the port's
``crimac_unet_tpu_torch/models/segformer.py``) as a benchmark
architecture; the contract of each function is in
``benchmark/architectures/unet.py``'s docstring.

Beside the contract it gives the laws of the attention kernels (the
port's ``ops/attention.py``): ``attention_flops`` and ``attention_bytes``
of a training step, which the ``attn_*`` readers hold the traced kernels
to.

A checkout whose program has no SegFormer cannot run this architecture's
cells: loading the adapter stops the run at once, naming the file that is
missing, before any input is made.
"""

from __future__ import annotations

import os

from benchmark.reference import segformer as ref
from benchmark.yardstick import counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROGRAM = os.path.join(ROOT, "crimac_unet_tpu_torch", "models",
                       "segformer.py")
if not os.path.isfile(PROGRAM):
    raise SystemExit(f"bench: the configuration names architecture "
                     f"'segformer', and this checkout's program has no "
                     f"SegFormer: {PROGRAM} does not exist")

N_CLASSES = 3
ALIGNMENT = 32


def _arch(cfg):
    return ref.arch_of(cfg)


def _cin(cfg):
    return len(cfg["frequencies"])


def init_state(cfg, gen, device):
    return ref.init_state(gen, device, _arch(cfg), _cin(cfg), N_CLASSES)


def calibrate(cfg, state, crops):
    """The decode head's BatchNorm set from the crops
    (``reference/segformer.py`` ``calibrate_bn``)."""
    return ref.calibrate_bn(state, crops, _arch(cfg))


def forward(cfg, state, x, quant=None, mode="eval"):
    return ref.forward(state, x, _arch(cfg), quant, mode)


def program(cfg):
    from crimac_unet_tpu_torch.models import build_model
    return build_model(cfg)


def _stages(cfg, h, w):
    """(hidden, heads, depth, sr, mlp ratio, kernel, cin, (h, w) of the
    stage's map) a stage."""
    a = _arch(cfg)
    cin = _cin(cfg)
    out = []
    for s, c in enumerate(a["hidden_sizes"]):
        k, stride = a["patch_sizes"][s], a["strides"][s]
        h = (h + 2 * (k // 2) - k) // stride + 1
        w = (w + 2 * (k // 2) - k) // stride + 1
        out.append((c, a["num_attention_heads"][s], a["depths"][s],
                    a["sr_ratios"][s], a["mlp_ratios"][s], k, cin, h, w))
        cin = c
    return out


def _pairs(cfg, h, w):
    """The query-key pairs one example's forward scores, summed over the
    blocks, a stage: (head dim, heads * N_q * N_kv * depth)."""
    return [(c // heads, heads * (hs * ws) * ((hs // sr) * (ws // sr))
             * depth)
            for c, heads, depth, sr, _, _, _, hs, ws in _stages(cfg, h, w)]


def forward_flops(cfg, h, w):
    """One (h, w) example's forward: every conv and linear and the two
    products of attention, multiply-adds counted twice (LayerNorm, GELU,
    softmax, the upsamplings and the BatchNorm are left out, as
    ``torch.utils.flop_counter`` leaves them out)."""
    total = 0
    stages = _stages(cfg, h, w)
    for c, heads, depth, sr, ratio, k, cin, hs, ws in stages:
        n, m = hs * ws, (hs // sr) * (ws // sr)
        inner = c * ratio
        total += counts.conv2d_flops(hs, ws, k, cin, c)     # patch embed
        block = (2 * n * c * c                 # query
                 + 2 * 2 * m * c * c           # key, value
                 + 2 * n * c * c               # output
                 + 4 * n * m * c               # q k^T, a v (all heads)
                 + 2 * n * c * inner * 2       # dense1, dense2
                 + 2 * n * inner * 9)          # depthwise 3x3
        if sr > 1:
            block += counts.conv2d_flops(hs // sr, ws // sr, sr, c, c)
        total += depth * block
    width = _arch(cfg)["decoder_hidden_size"]
    n1 = stages[0][7] * stages[0][8]
    total += sum(2 * hs * ws * c * width
                 for c, _, _, _, _, _, _, hs, ws in stages)  # linear_c
    total += 2 * n1 * width * len(stages) * width        # linear_fuse
    total += 2 * n1 * width * N_CLASSES                  # classifier
    return int(total)


def train_step_flops(cfg, batch, h, w):
    """A training step: forward, and the backward's two products (input
    and weight gradients), each as many FLOPs as the forward."""
    return 3 * batch * forward_flops(cfg, h, w)


def attention_flops(cfg, batch, h, w):
    """A training step's attention products: ``12 * head_dim`` FLOPs a
    query-key pair (the forward's two products, 4 d, and the backward's
    four, 8 d; a recompute of the scores is not counted), summed over
    the layers."""
    return sum(12 * d * batch * p for d, p in _pairs(cfg, h, w))


def attention_bytes(cfg, batch, h, w, itemsize=2):
    """The attention kernels' bytes in a training step, each input read
    once and each output written once a call: forward reads q, k, v and
    writes o and the float32 row log-sum-exp; backward reads q, k, v, o,
    do and the log-sum-exp and writes dq, dk, dv."""
    total = 0
    for c, heads, depth, sr, _, _, _, hs, ws in _stages(cfg, h, w):
        n, m = hs * ws, (hs // sr) * (ws // sr)
        fwd = (2 * n * c + 2 * m * c) * itemsize + n * heads * 4
        bwd = (4 * n * c + 4 * m * c) * itemsize + n * heads * 4
        total += depth * batch * (fwd + bwd)
    return int(total)


def slab_alignment(cfg):
    """None: attention reaches the whole window, so no slab mode."""
    return None


def k3_channels(cfg):
    """None: SegFormer runs no K3."""
    return None


def check_config(cfg):
    """MiT-B2 as published, with its decode head, at crops whose sides
    are multiples of 32 (every stride and spatial reduction then divides
    its stage's map)."""
    if cfg.get("architecture") != "segformer":
        raise ValueError(f"architecture is {cfg.get('architecture')!r}, not "
                         "'segformer'")
    got = _arch(cfg)
    for k, v in ref.MIT_B2.items():
        if got[k] != v:
            raise ValueError(f"{k} is {got[k]!r}, not MiT-B2's {v!r}")
    size = cfg.get("patch_size")
    if not (isinstance(size, list) and len(size) == 2
            and all(int(s) > 0 and int(s) % ALIGNMENT == 0 for s in size)):
        raise ValueError(f"patch_size {size!r} is not two multiples of "
                         f"{ALIGNMENT}")
