"""Checkpoints of the port: the reference ``.pt`` state dict and the JAX
package's flax msgpack checkpoints.

The reference's plain ``state_dict`` (``down_convs.{i}.main.{0,1,3,4}``,
``up_convs.{i}.{upconv,conv1,bn1,conv2,bn2}``, ``conv_final``) is the
port's module layout.  The JAX package's ``best``/``last`` checkpoints are
flax msgpack files of ``{"params", "batch_stats", "opt_state", "step"}``
(``crimac_unet_tpu/pipeline/engine.py`` ``save_checkpoint``); the port
reads them with its own codec (utils/flax_msgpack.py) and maps them with
:func:`flax_to_torch_state_dict`, and its trainer writes them back in the
same layout through :func:`torch_to_flax_params` /
:func:`torch_to_flax_variables`, so each package serves and resumes the
other's checkpoints.  :func:`load_torch_checkpoint` /
:func:`save_torch_checkpoint` are the JAX package's
``models/torch_import.py`` names: a reference ``.pt`` file to and from
``{"params", "batch_stats"}`` numpy variables.

Layout conversion (flax <-> reference):
  Conv          (kh, kw, I, O)                      <-> (O, I, kh, kw)
  ConvTranspose (kh, kw, I, O), spatially flipped   <-> (I, O, kh, kw)
  Dense         (I, O)  meta_mlp/fc{1,2,3}          <-> (O, I)
                post_processing_weights.main.{0,2,4}
  BatchNorm     params scale/bias, batch_stats mean/var
                <-> weight/bias, running_mean/running_var
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import flax_msgpack


def _layers(depth: int, late_meta: bool):
    """(torch prefix, flax path, kind) of every layer, in flax's module
    creation order."""
    for i in range(depth):
        p = f"down_convs.{i}.main"
        for unit, conv, bn in (("unit1", 0, 1), ("unit2", 3, 4)):
            yield f"{p}.{conv}", (f"down{i}", unit, "conv"), "conv"
            yield f"{p}.{bn}", (f"down{i}", unit, "bn"), "bn"
    for i in range(depth - 1):
        p = f"up_convs.{i}"
        yield f"{p}.upconv", (f"up{i}", "upconv"), "convT"
        for unit, n in (("unit1", 1), ("unit2", 2)):
            yield f"{p}.conv{n}", (f"up{i}", unit, "conv"), "conv"
            yield f"{p}.bn{n}", (f"up{i}", unit, "bn"), "bn"
    if late_meta:
        for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
            yield (f"post_processing_weights.main.{i}", ("meta_mlp", fc),
                   "dense")
    yield "conv_final", ("conv_final",), "conv"


def _flax_weight(kind: str, w: np.ndarray) -> np.ndarray:
    """Reference weight layout -> flax kernel layout."""
    if kind == "conv":
        return w.transpose(2, 3, 1, 0)
    if kind == "convT":
        # torch ConvTranspose2d correlates with the kernel spatially
        # flipped relative to flax.linen.ConvTranspose
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.T


def _torch_weight(kind: str, k: np.ndarray) -> np.ndarray:
    """flax kernel layout -> reference weight layout."""
    if kind == "conv":
        return k.transpose(3, 2, 0, 1)
    if kind == "convT":
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    return k.T


_LEAVES = {"bn": (("weight", "scale"), ("bias", "bias"))}
_DEFAULT_LEAVES = (("weight", "kernel"), ("bias", "bias"))


def _geometry(names) -> tuple:
    depth = 1 + max(int(k.split(".")[1]) for k in names
                    if k.startswith("down_convs."))
    return depth, any(k.startswith("post_processing_weights") for k in names)


def _f32(a) -> np.ndarray:
    """A float32 copy (never a view of a live torch parameter)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float32, order="C")


def _put(tree: dict, path: tuple, leaf: str, value) -> None:
    node = tree
    for key in path:
        node = node.setdefault(key, {})
    node[leaf] = value


def _get(tree: dict, path: tuple) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def torch_to_flax_params(named: dict) -> dict:
    """Reference-named weights and biases (a state dict, or any tensor per
    parameter such as SGD momentum buffers) -> the flax ``params`` tree of
    float32 numpy arrays."""
    params: dict = {}
    for prefix, path, kind in _layers(*_geometry(named)):
        for tname, fname in _LEAVES.get(kind, _DEFAULT_LEAVES):
            v = _f32(named[f"{prefix}.{tname}"])
            if tname == "weight" and kind != "bn":
                v = np.ascontiguousarray(_flax_weight(kind, v))
            _put(params, path, fname, v)
    return params


def torch_to_flax_variables(state_dict: dict) -> dict:
    """Reference state dict -> ``{"params", "batch_stats"}`` of the JAX
    package's U-Net (numpy arrays)."""
    stats: dict = {}
    for prefix, path, kind in _layers(*_geometry(state_dict)):
        if kind == "bn":
            _put(stats, path, "mean", _f32(state_dict[prefix
                                                      + ".running_mean"]))
            _put(stats, path, "var", _f32(state_dict[prefix
                                                     + ".running_var"]))
    return {"params": torch_to_flax_params(state_dict), "batch_stats": stats}


def torch_state_dict_to_flax(sd: dict) -> dict:
    """The JAX package's name for :func:`torch_to_flax_variables`."""
    return torch_to_flax_variables(sd)


def flax_params_to_torch(params: dict) -> dict:
    """flax ``params`` tree (or a tree of the same shape, such as optax's
    momentum ``trace``) -> reference-named numpy arrays of the weights
    and biases, in the tree's dtype."""
    depth = 1 + max(int(k[4:]) for k in params if k.startswith("down"))
    out: dict = {}
    for prefix, path, kind in _layers(depth, "meta_mlp" in params):
        node = _get(params, path)
        for tname, fname in _LEAVES.get(kind, _DEFAULT_LEAVES):
            v = np.asarray(node[fname])
            if tname == "weight" and kind != "bn":
                v = _torch_weight(kind, v)
            out[f"{prefix}.{tname}"] = np.ascontiguousarray(v)
    return out


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
    sd = flax_params_to_torch(params)
    depth = 1 + max(int(k[4:]) for k in params if k.startswith("down"))
    for prefix, path, kind in _layers(depth, "meta_mlp" in params):
        if kind == "bn":
            s = _get(stats, path)
            sd[prefix + ".running_mean"] = np.asarray(s["mean"], np.float32)
            sd[prefix + ".running_var"] = np.asarray(s["var"], np.float32)
            # torch's BatchNorm2d carries a batch count that
            # load_state_dict (strict) requires; nothing reads it
            sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def to_tensors(state_dict: dict) -> dict:
    """numpy/tensor state dict -> CPU tensors (float32 / int64 as given)."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v))
            for k, v in state_dict.items()}


def read_msgpack_checkpoint(path) -> dict:
    """The whole tree of a flax msgpack checkpoint (numpy leaves)."""
    with open(path, "rb") as f:
        tree = flax_msgpack.unpackb(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a flax checkpoint (no 'params')")
    return tree


def load_checkpoint(path) -> dict:
    """Model weights as a reference state dict of CPU tensors: a ``.pt``
    file (a reference state dict, or the port's own checkpoint, whose
    ``state_dict`` it returns: ``pipeline/engine.py``), or any other file
    as a flax msgpack checkpoint of the JAX package (as its
    ``engine.load_checkpoint`` reads them)."""
    path = str(path)
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return sd["state_dict"] if "architecture" in sd else sd
    return to_tensors(flax_to_torch_state_dict(
        read_msgpack_checkpoint(path)))


def load_torch_checkpoint(path) -> dict:
    """A reference ``.pt`` state dict file -> ``{"params",
    "batch_stats"}`` numpy variables of the JAX package's U-Net."""
    return torch_to_flax_variables(
        torch.load(str(path), map_location="cpu", weights_only=True))


def save_torch_checkpoint(variables: dict, path) -> None:
    """``{"params", "batch_stats"}`` variables -> a reference-loadable
    ``.pt`` state dict (needs unfolded BatchNorm variables)."""
    torch.save(to_tensors(flax_to_torch_state_dict(variables)), str(path))
