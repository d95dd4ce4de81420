"""Checkpoints of the port: the reference ``.pt`` state dict.

The port's checkpoint format is the reference's plain ``state_dict``
(``down_convs.{i}.main.{0,1,3,4}``, ``up_convs.{i}.{upconv,conv1,bn1,
conv2,bn2}``, ``conv_final``).  A JAX msgpack checkpoint reaches the port
through the JAX package's ``models/torch_import.save_torch_checkpoint``;
:func:`flax_to_torch_state_dict` is the port's own copy of that mapping
for callers that hold JAX variables as numpy arrays (tests, tools).

Layout conversion (flax -> reference):
  Conv         (kh, kw, I, O)                      -> (O, I, kh, kw)
  ConvTranspose (kh, kw, I, O), spatially flipped  -> (I, O, kh, kw)
  Dense        (I, O)  meta_mlp/fc{1,2,3}          -> (O, I)
               post_processing_weights.main.{0,2,4}
"""

from __future__ import annotations

import numpy as np
import torch


def flax_to_torch_state_dict(variables: dict) -> dict:
    """JAX UNet variables ({'params', 'batch_stats'} as numpy arrays) ->
    reference state dict of numpy arrays.  Needs unfolded BatchNorm
    variables (a training checkpoint)."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    if not stats:
        raise ValueError(
            "flax_to_torch_state_dict needs unfolded batch_stats (a "
            "training checkpoint); BN-folded serving params cannot be "
            "exported to the reference's state_dict format")
    sd: dict = {}

    def put_conv(prefix, p):
        sd[prefix + ".weight"] = np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[prefix + ".bias"] = np.asarray(p["bias"], np.float32)

    def put_convT(prefix, p):
        k = np.asarray(p["kernel"], np.float32)[::-1, ::-1]
        sd[prefix + ".weight"] = np.ascontiguousarray(
            k.transpose(2, 3, 0, 1))
        sd[prefix + ".bias"] = np.asarray(p["bias"], np.float32)

    def put_bn(prefix, p, s):
        sd[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
        sd[prefix + ".bias"] = np.asarray(p["bias"], np.float32)
        sd[prefix + ".running_mean"] = np.asarray(s["mean"], np.float32)
        sd[prefix + ".running_var"] = np.asarray(s["var"], np.float32)
        # torch's BatchNorm2d carries a batch count that load_state_dict
        # (strict) requires; nothing reads it
        sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)

    depth = 1 + max(int(k[4:]) for k in params if k.startswith("down"))
    for i in range(depth):
        fp, fs = params[f"down{i}"], stats[f"down{i}"]
        p = f"down_convs.{i}.main"
        put_conv(f"{p}.0", fp["unit1"]["conv"])
        put_bn(f"{p}.1", fp["unit1"]["bn"], fs["unit1"]["bn"])
        put_conv(f"{p}.3", fp["unit2"]["conv"])
        put_bn(f"{p}.4", fp["unit2"]["bn"], fs["unit2"]["bn"])

    for i in range(depth - 1):
        fp, fs = params[f"up{i}"], stats[f"up{i}"]
        p = f"up_convs.{i}"
        put_convT(f"{p}.upconv", fp["upconv"])
        put_conv(f"{p}.conv1", fp["unit1"]["conv"])
        put_bn(f"{p}.bn1", fp["unit1"]["bn"], fs["unit1"]["bn"])
        put_conv(f"{p}.conv2", fp["unit2"]["conv"])
        put_bn(f"{p}.bn2", fp["unit2"]["bn"], fs["unit2"]["bn"])

    put_conv("conv_final", params["conv_final"])

    if "meta_mlp" in params:
        # late-inject metadata MLP (crimac_unet_tpu/models/torch_import.py
        # flax_to_torch_state_dict)
        for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
            p = f"post_processing_weights.main.{i}"
            sd[p + ".weight"] = np.ascontiguousarray(
                np.asarray(params["meta_mlp"][fc]["kernel"], np.float32).T)
            sd[p + ".bias"] = np.asarray(params["meta_mlp"][fc]["bias"],
                                         np.float32)
    return sd


def to_tensors(state_dict: dict) -> dict:
    """numpy/tensor state dict -> CPU tensors (float32 / int64 as given)."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v))
            for k, v in state_dict.items()}


def load_checkpoint(path) -> dict:
    """Load a reference ``.pt`` state dict onto the CPU."""
    path = str(path)
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the port loads reference .pt state dicts; convert a "
            "JAX msgpack checkpoint with the JAX package's "
            "crimac_unet_tpu.models.torch_import.save_torch_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=True)
