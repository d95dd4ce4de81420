"""BatchNorm folding for inference serving.

At inference BatchNorm is a per-channel affine transform with frozen
running statistics; after a convolution it folds exactly into the conv's
weight and bias:

    BN(conv(x)) = conv(x) * g + c
      with g = gamma / sqrt(var + eps),  c = beta - mean * g
    => weight' = weight * g (per output channel),  bias' = bias * g + c

Same float32 arithmetic and the same serving policy as the JAX package's
``crimac_unet_tpu/models/fold_bn.py`` (``fold_for_serving``:69), on the
reference state-dict layout (conv weights ``(O, I, kh, kw)``).  The
SegFormer (models/segformer.py) has one BatchNorm, after its decode
head's fuse conv, which has no bias: the folded conv gets ``c`` as its
bias.
"""

from __future__ import annotations

import torch

# (conv prefix, bn prefix) pairs of the reference naming
_DOWN_UNITS = (("main.0", "main.1"), ("main.3", "main.4"))
_UP_UNITS = (("conv1", "bn1"), ("conv2", "bn2"))
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
_SEGFORMER_PAIR = ("decode_head.linear_fuse", "decode_head.batch_norm")


def _conv_bn_pairs(state_dict: dict):
    if _SEGFORMER_PAIR[1] + ".running_var" in state_dict:
        yield _SEGFORMER_PAIR
        return
    depth = 1 + max(int(k.split(".")[1]) for k in state_dict
                    if k.startswith("down_convs."))
    for i in range(depth):
        for conv, bn in _DOWN_UNITS:
            yield f"down_convs.{i}.{conv}", f"down_convs.{i}.{bn}"
    for i in range(depth - 1):
        for conv, bn in _UP_UNITS:
            yield f"up_convs.{i}.{conv}", f"up_convs.{i}.{bn}"


def has_batch_stats(state_dict: dict) -> bool:
    return any(k.endswith(".running_var") for k in state_dict)


def fold_state_dict(state_dict: dict, eps: float = 1e-5) -> dict:
    """State dict of a BN model -> state dict of the equivalent
    ``use_bn=False`` model (BN entries dropped, folded into the convs)."""
    if not has_batch_stats(state_dict):
        raise ValueError(
            "the checkpoint carries no BatchNorm running statistics — "
            "folding is impossible")
    out = dict(state_dict)
    for conv, bn in _conv_bn_pairs(state_dict):
        g = state_dict[bn + ".weight"] / torch.sqrt(
            state_dict[bn + ".running_var"] + eps)
        c = state_dict[bn + ".bias"] - state_dict[bn + ".running_mean"] * g
        out[conv + ".weight"] = state_dict[conv + ".weight"] * g.view(
            -1, 1, 1, 1)
        bias = state_dict.get(conv + ".bias")
        out[conv + ".bias"] = c if bias is None else bias * g + c
        for f in _BN_FIELDS:
            out.pop(f"{bn}.{f}", None)
    return out


def fold_for_serving(model, state_dict: dict, config) -> tuple:
    """The serving BN policy (same as the JAX package's
    ``fold_for_serving``): returns ``(model, state_dict)`` ready for
    ``model.load_state_dict``.

    * BN model + ``fold_bn`` (default true): statistics folded into the
      conv weights, BN dropped from the graph (``use_bn=False``).
    * BN model + ``fold_bn: false``: unfolded eval-mode forward; the
      checkpoint must carry the running statistics either way.
    * BN-free model: the state dict as it is.
    """
    if not model.use_bn:
        return model, state_dict
    if not has_batch_stats(state_dict):
        raise ValueError(
            "the checkpoint carries no BatchNorm running statistics for "
            "this BN model — serve from a training checkpoint, or build "
            "the model with use_bn=False")
    if config.get("fold_bn", True):
        folded = type(model)(**dict(model.hparams, use_bn=False))
        return folded, fold_state_dict(state_dict)
    return model, state_dict
