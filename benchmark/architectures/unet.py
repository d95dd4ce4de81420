"""The flagship U-Net (``benchmark/reference/unet.py``; the port's
``crimac_unet_tpu_torch/models/unet.py``) as a benchmark architecture.

A configuration file names its architecture as ``"architecture":
"<name>"``; without the key it is ``unet``.  ``benchmark/run.py`` loads
``benchmark/architectures/<name>.py`` under the run's root and hands the
module to the cell's ``build``, so a second architecture enters as new
files: its configuration, its plain reference under
``benchmark/reference/``, and an adapter beside this one.  An adapter
imports nothing of the program when it is loaded, and its reference
nothing of the program at all.  Every function takes the configuration as
the cell runs it:

``init_state(cfg, gen, device)``
    float32 weights made on ``device`` from the generator ``gen``, keyed
    by the program's state-dict names.
``calibrate(cfg, state, crops)``
    the state a prediction cell serves, given (N, C, H, W) dB crops of
    its survey; an architecture with nothing to calibrate returns
    ``state``.
``forward(cfg, state, x, quant=None, mode="eval")``
    the plain reference: (N, C, H, W) float32 dB in, (N, n_classes, H,
    W) logits out; ``quant="fp8"`` the control; ``mode`` ``"eval"``,
    ``"train"`` (batch statistics, gradients through them) or
    ``"calibrate"``.
``program(cfg)``
    the port's eval model, which ``GriddedRunner`` serves; the program is
    imported inside the call.
``forward_flops(cfg, h, w)``, ``train_step_flops(cfg, batch, h, w)``
    the useful FLOPs of one (h, w) example's forward, and of a training
    step of ``batch`` such examples.
``slab_alignment(cfg)``
    what slab mode pads a chunk's grid to a multiple of; ``None``: no
    slab mode, and a slab-mode cell stops at its build.
``k3_channels(cfg)``
    the channels of the level-0 map that K3 (``relu_pool_skip``) reads;
    ``None``: the architecture runs no K3, and its prediction cells count
    no K3 bytes.
``check_config(cfg)``
    raises ``ValueError`` where the configuration file is not one this
    architecture's cells are sized for.
"""

from __future__ import annotations

from benchmark.reference import unet as ref_unet
from benchmark.yardstick import counts


def _depth(cfg):
    return int(cfg["depth"])


def _filts(cfg):
    return int(cfg["start_filts"])


def init_state(cfg, gen, device):
    return ref_unet.init_state(gen, device, _depth(cfg), _filts(cfg),
                               len(cfg["frequencies"]))


def calibrate(cfg, state, crops):
    """The first BatchNorm's running statistics set from the crops
    (``reference/unet.py`` ``calibrate_bn`` says why only the first)."""
    return ref_unet.calibrate_bn(state, crops, _depth(cfg))


def forward(cfg, state, x, quant=None, mode="eval"):
    return ref_unet.forward(state, x, _depth(cfg), quant, bn_mode=mode)


def program(cfg):
    from crimac_unet_tpu_torch.models.unet import build_unet
    return build_unet(cfg)


def forward_flops(cfg, h, w):
    return counts.unet_forward_flops(h, w, depth=_depth(cfg),
                                     start_filts=_filts(cfg))


def train_step_flops(cfg, batch, h, w):
    return counts.train_step_flops(batch, h, w, depth=_depth(cfg),
                                   start_filts=_filts(cfg))


def slab_alignment(cfg):
    """The pooling alignment: ``depth - 1`` 2x2 pools halve the grid."""
    return 2 ** (_depth(cfg) - 1)


def k3_channels(cfg):
    return _filts(cfg)


def check_config(cfg):
    """The published U-Net the cells are sized for: depth 5, 64 start
    filters, 256 x 256 patches."""
    got = (cfg.get("depth"), cfg.get("start_filts"), cfg.get("patch_size"))
    if got != (5, 64, [256, 256]):
        raise ValueError(f"(depth, start_filts, patch_size) is {got}, not "
                         "(5, 64, [256, 256])")
