"""AOT serving export: the inference forward as a ``torch.export`` artifact.

The port's counterpart of ``crimac_unet_tpu/pipeline/export.py``.  The
serving forward — the gather_db front end (non-finite scrub, dB + clip,
or the dequantization of uint8 dB codes), the BatchNorm-folded U-Net
(``relu_pool_skip`` at level 0; ``maxpool2x2`` with ``fold_bn: false``)
and a float32 softmax — is traced ONCE with ``torch.export`` and saved
with its weights.  The hand-written kernels are the ``crimac::``
operators (ops/cuda_lib.py ``define_op``), so the graph records their
launches: on a CUDA device the artifact runs the kernels, on the CPU
their plain versions.

Divergence from the JAX artifact, which needs jax alone: loading this
one needs torch AND this package (importing this module registers the
``crimac::`` operators), but no model source, config or checkpoint.  The artifact is traced on one
device and moved at load (``torch.export.passes.move_to_device_pass``).

Input contract: NHWC patches ``(batch, *patch_size, len(frequencies))``
(patch mode, batch symbolic or fixed) or whole chunks ``(batch, range,
ping, len(frequencies))`` with range and ping multiples of
``2**(depth-1)`` (slab mode, every dimension symbolic), frequency
channels in ascending order.  The input dtype follows ``transfer_dtype``:
float32 raw sv (the export default: exact), bfloat16 raw sv, or uint8
host-computed dB codes (``pipeline.infer_common._quantize_db_u8``).
Metadata models take a second float32 NHWC input of ``get_in_channels``
channels with the same leading dimensions.  Output: float32 softmax
probabilities ``(batch, H, W, 3)``, or with ``output_dtype: uint8`` the
codes ``round(p * 255)``.  As in the JAX package the artifact reproduces
the ZARR serving path: memm prediction also zeroes dB pixels outside the
data extent (the border), which patches alone cannot carry, so
``export_checkpoint`` warns on ``data_mode: memm``.

    python -m crimac_unet_tpu_torch.pipeline.export --yaml_path cfg.yaml \\
        --checkpoint_path best.msgpack --out unet.pt2 \\
        [--batch N] [--mode patch|slab] [--device cpu]
"""

from __future__ import annotations

import io
import os
import warnings

import torch
import torch.nn as nn
from torch.export.passes import move_to_device_pass

from ..data.meta_channels import get_in_channels, validate_meta_channels
from ..models.fold_bn import fold_for_serving
from ..models.weights import to_tensors
# importing the kernel modules registers the crimac:: operators an
# artifact names, before torch.export.load looks them up
from ..ops import closing, pool  # noqa: F401
from ..ops.gather_db import gather_db
from .infer_common import _quantize_prob_u8
from .runner import resolve_device

# artifact header: the format and calling convention written here; the
# JAX package's artifacts start with its own
_MAGIC = b"CRIMACT1"
_JAX_MAGIC = b"CRIMACX1"

_INPUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "uint8": torch.uint8}
# symbolic dimensions: the batch and the slab's range and ping extents
# stay inside the kernels' limits (gather_db: 65535 windows; int32 starts
# batch * range)
MAX_BATCH = 65535
MAX_SLAB_EXTENT = 16384


class ServingForward(nn.Module):
    """Raw sv patches (or uint8 dB codes) -> softmax probabilities (or
    their uint8 codes): gather_db over the batch viewed as one (B*H, W, C)
    slab with a window of (H, W) per patch and no border, the folded
    U-Net in eval mode, float32 softmax.  ``meta`` (metadata models) is
    concatenated to the input bands (early inject) or handed to the
    model's MLP (late inject)."""

    def __init__(self, model, late: bool, scaled: bool, u8_out: bool):
        super().__init__()
        self.model = model
        self.late = late
        self.scaled = scaled
        self.u8_out = u8_out

    def forward(self, x, meta=None):
        B, H, W, C = x.shape
        starts = torch.arange(B, dtype=torch.int32, device=x.device) * H
        d = gather_db(x.contiguous().view(B * H, W, C), starts,
                      torch.zeros_like(starts), (H, W), scaled=self.scaled,
                      out_dtype=self.model.dtype)
        if meta is not None and not self.late:
            d = torch.cat([d, meta.to(d.dtype)], dim=-1)
            meta = None
        # _forward, not forward: the model's eval forward wraps itself in
        # no_grad, which an exported graph keeps as a submodule
        logits = self.model._forward(d, meta, train=False)
        probs = torch.softmax(logits, dim=-1)
        return _quantize_prob_u8(probs) if self.u8_out else probs


def make_serving_forward(model, state_dict, config, device=None):
    """The serving forward of ``model`` with ``state_dict`` as an eval-mode
    ``nn.Module`` on ``device`` (cuda unless asked otherwise): BatchNorm
    folded unless the model has none or ``fold_bn: false``, parameters
    frozen, channels_last as the live runner holds them.  Call it with
    ``(x)`` or, for metadata models, ``(x, meta)``.  Only the U-Net
    exports."""
    from ..models.unet import UNet
    if not isinstance(model, UNet):
        raise ValueError(f"export serves the U-Net only, not a "
                         f"{type(model).__name__}: serve it live in patch "
                         "mode (save_predict)")
    validate_meta_channels(config.get("meta_channels"))
    n_meta = get_in_channels(config.get("meta_channels"))
    late = bool(config.get("late_meta_inject"))
    if late and n_meta == 0:
        raise ValueError(
            "late_meta_inject with zero metadata channels cannot export "
            "(the model demands a meta input the config never produces — "
            "the live runner rejects this combination too)")
    od = str(config.get("output_dtype", "float16"))
    if od == "float32":
        raise ValueError(
            "output_dtype 'float32' is not a setting: the default "
            "('float16') artifact already RETURNS float32 softmax "
            "probabilities — 'float16' names the live pipeline's d2h/"
            "on-disk dtype.  Use the default, or 'uint8' for round(p*255) "
            "codes.")
    if od not in ("float16", "uint8"):
        raise ValueError(f"output_dtype must be 'float16' or 'uint8', "
                         f"got {od!r}")
    dev = resolve_device(device if device is not None
                         else config.get("device"))
    model, state_dict = fold_for_serving(model, to_tensors(state_dict),
                                         config)
    model.load_state_dict(state_dict)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    fwd = ServingForward(model, late, n_meta > 0, od == "uint8")
    return fwd.requires_grad_(False)


def _export_input_dtype(config) -> torch.dtype:
    """Artifact input dtype from ``transfer_dtype``: float32 (exact, the
    export default), bfloat16 or uint8 (host-computed dB codes)."""
    td = str(config.get("transfer_dtype", "float32"))
    if td not in _INPUT_DTYPES:
        raise ValueError(f"transfer_dtype must be one of "
                         f"{sorted(_INPUT_DTYPES)}, got {td!r}")
    return _INPUT_DTYPES[td]


def _export(fwd, config, shape, dims):
    """Trace ``fwd`` on example inputs of ``shape`` (acoustic bands last)
    with ``dims`` (index -> Dim) symbolic; metadata models get a second
    float32 input sharing those dimensions."""
    dev = next(fwd.parameters()).device
    dtype = _export_input_dtype(config)
    n_meta = get_in_channels(config.get("meta_channels"))
    args = (torch.zeros(shape, dtype=dtype, device=dev),)
    if n_meta:
        args += (torch.zeros(shape[:3] + (n_meta,), device=dev),)
    shapes = tuple(dict(dims) for _ in args) if dims else None
    return torch.export.export(fwd, args, dynamic_shapes=shapes)


def export_predictor(model, state_dict, config, batch=None, device=None):
    """Export the patch serving forward; returns the ``ExportedProgram``.

    ``batch``: an int for a fixed batch, None (default) for a symbolic
    one (traced on an example batch of 2: an example of 1 would make the
    batch a constant).  ``device``: where the trace runs (cuda unless
    asked otherwise); ``load_predictor`` moves the program."""
    fwd = make_serving_forward(model, state_dict, config, device)
    wh, ww = (int(s) for s in config["patch_size"])
    n_ch = len(config["frequencies"])
    if batch is None:
        dims = {0: torch.export.Dim("b", min=1, max=MAX_BATCH)}
        shape = (2, wh, ww, n_ch)
    else:
        dims = None
        shape = (int(batch), wh, ww, n_ch)
    return _export(fwd, config, shape, dims)


def export_slab_predictor(model, state_dict, config, device=None):
    """Export the fully-convolutional slab serving forward (``infer_mode:
    slab``): batch, range and ping all symbolic, range and ping multiples
    of ``2**(depth-1)`` — the pooling alignment, taken from the MODEL's
    depth, not the config's.  An unaligned chunk fails at call time."""
    fwd = make_serving_forward(model, state_dict, config, device)
    align = 2 ** (int(model.depth) - 1)
    n_ch = len(config["frequencies"])
    top = MAX_SLAB_EXTENT // align
    dims = {0: torch.export.Dim("b", min=1, max=MAX_BATCH),
            1: align * torch.export.Dim("h", min=1, max=top),
            2: align * torch.export.Dim("w", min=1, max=top)}
    return _export(fwd, config, (2, 2 * align, 2 * align, n_ch), dims)


def save_exported(exported, path) -> None:
    """Write ``exported`` to ``path``: the header, then the
    ``torch.export.save`` archive.  Atomic (temp file + os.replace):
    re-exporting over a live artifact never leaves a truncated file."""
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are not "contiguous" to the archive
        # writer, which then warns; each weight owns its storage and is
        # written whole, strides included
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(exported, buf)
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(buf.getbuffer())
    os.replace(tmp, path)


def load_predictor(path, device=None):
    """Load a saved artifact onto ``device`` (cuda unless asked otherwise;
    raises without a card) -> callable ``predict(x[, meta])`` on tensors
    of that device.  Needs torch and this package, not the model source
    or a checkpoint."""
    with open(path, "rb") as f:
        header = f.read(len(_MAGIC))
        if header == _JAX_MAGIC:
            raise ValueError(
                f"{path} is a JAX-package artifact ({_JAX_MAGIC!r}, a "
                "jax.export StableHLO program): load it with "
                "crimac_unet_tpu.pipeline.export.load_predictor, or export "
                "the checkpoint with crimac_unet_tpu_torch.pipeline.export")
        if header != _MAGIC:
            raise ValueError(
                f"{path} is not a crimac_unet_tpu_torch export artifact "
                f"(missing {_MAGIC!r} header)")
        payload = io.BytesIO(f.read())
    dev = resolve_device(device)
    ep = move_to_device_pass(torch.export.load(payload), dev)
    module = ep.module()
    dtypes = [v.dtype for v in input_specs(ep)]

    def predict(*inputs):
        # the graph checks shapes; the calling convention's dtypes are
        # checked here (float32 sv fed to a uint8-code artifact would
        # otherwise run as raw sv)
        got = [getattr(t, "dtype", type(t)) for t in inputs]
        if got != dtypes:
            raise ValueError(f"the artifact takes inputs of dtypes "
                             f"{dtypes}, got {got}")
        with torch.no_grad():
            return module(*inputs)

    return predict


def input_specs(exported) -> list:
    """The user inputs of an exported program as fake tensors (symbolic
    shapes, dtype, device)."""
    vals = {n.name: n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder"}
    return [vals[name] for name in exported.graph_signature.user_inputs]


def export_checkpoint(checkpoint_path, config, out_path, batch=None,
                      device=None, mode="patch"):
    """Checkpoint file (``.pt`` or flax msgpack) -> saved serving
    artifact; returns the ``ExportedProgram``.  ``mode``: 'patch'
    (``patch_size`` windows, ``batch`` fixed or symbolic) or 'slab'
    (whole chunks, every dimension symbolic — ``batch`` must be None)."""
    from ..models import architecture
    from ..models.unet import build_unet
    from ..models.weights import load_checkpoint

    if architecture(config) != "unet":
        raise ValueError(f"export serves the U-Net only; the config names "
                         f"architecture {architecture(config)!r}: serve it "
                         "live in patch mode (save_predict)")
    if mode not in ("patch", "slab"):
        raise ValueError(f"unknown export mode {mode!r}: "
                         "expected 'patch' or 'slab'")
    if mode == "slab" and batch is not None:
        raise ValueError(
            "mode='slab' artifacts have a symbolic batch dimension; a "
            "fixed --batch cannot be honored — drop it")
    state_dict = load_checkpoint(checkpoint_path)
    model = build_unet(config)
    if config.get("data_mode") == "memm":
        warnings.warn(
            "exporting from a data_mode: memm config — the artifact "
            "reproduces the ZARR serving path; the memm predict path "
            "additionally zeroes dB-space pixels outside the data extent "
            "(border_zero), which the artifact cannot replicate, so "
            "probabilities near data boundaries will differ from the live "
            "memm runner", stacklevel=2)
    if mode == "slab":
        exported = export_slab_predictor(model, state_dict, config,
                                         device=device)
    else:
        exported = export_predictor(model, state_dict, config, batch=batch,
                                    device=device)
    save_exported(exported, out_path)
    return exported


def main(argv=None):
    """CLI: checkpoint + config -> serving artifact."""
    import argparse

    from ..config import load_yaml_config, parse_config_options

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--yaml_path", required=True)
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch size (default: symbolic)")
    p.add_argument("--mode", choices=("patch", "slab"), default="patch",
                   help="patch: fixed patch_size windows; slab: whole "
                        "chunks (symbolic pooling-aligned range/ping)")
    p.add_argument("--device", default=None,
                   help="device the trace runs on (default: cuda); the "
                        "artifact is moved to the loader's device")
    args = p.parse_args(argv)
    config = parse_config_options(load_yaml_config(args.yaml_path))
    exported = export_checkpoint(args.checkpoint_path, config, args.out,
                                 batch=args.batch, device=args.device,
                                 mode=args.mode)
    x = input_specs(exported)[0]
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"traced on {x.device}, input {x.dtype} {tuple(x.shape)} "
          f"({args.mode})")


if __name__ == "__main__":
    main()
