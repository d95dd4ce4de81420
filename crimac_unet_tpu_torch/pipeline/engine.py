"""Training and validation steps, losses, the LR schedule and checkpoints.

The port's counterpart of ``crimac_unet_tpu/pipeline/engine.py``.  Every
step runs on the device from the raw crop batch:

  train step: augmentation -> label train chain (refine with the K4
              closing, convert) -> data train chain -> forward (autograd,
              flax BatchNorm) -> loss (ignore-masked) -> SGD update
  eval step:  label test chain (K4 again) -> data test chain -> eval
              forward (K2 at level 0) -> loss on ignore-collapsed labels
              + streaming PR histogram update

With metadata channels (``meta_channels``) a step also takes the
(B, M, H, W) metadata crops: the augmentation flips them with the data
(``augment_train_meta``, noise on the acoustic channels only), the dB
transform is the scaled [0, 1] one, and early inject concatenates them
after the acoustic channels while late inject hands them to the model.
The pooled steps compute them on the device from the pool's vectors
(data/device_pool.gather_meta_crops).

Hyper-parameters follow the reference: SGD momentum 0.95, lr 0.005
halved every ``lr_step`` optimizer steps (staircase ExponentialLR,
pipeline.py:156-157/:187-189), CE class weights [10, 300, 250]
(pipeline.py:132-141) with torch's weighted-mean normalization and
ignore_index=-100 behaviour.  optax's ``sgd(momentum)`` (trace, then
scale by ``-lr(count)``) is ``torch.optim.SGD(momentum, dampening=0,
nesterov=False)``; the step sets ``lr = lr0 * lr_reduction ** (step //
lr_step)`` before each update, ``step`` counting the updates already taken
(optax's ``count`` before its increment).

Checkpoints are the JAX package's flax msgpack files
``{"params", "batch_stats", "opt_state", "step"}`` with ``opt_state`` =
optax's ``(TraceState(trace=<params tree>), ScaleByScheduleState(count))``
as flax stores a tuple (``{"0": {"trace": ...}, "1": {"count": ...}}``),
written atomically with the ``<path>.json`` sidecar first.  A step
returns its loss as a device scalar and syncs nothing with the host.

Under a data mesh (``mesh``, parallel/mesh.py) each rank runs a step on
its rows of the global batch and the step computes what one device
computes on the whole batch: the augmentation is drawn for the global
batch from the generator every rank seeds alike and applied to this
rank's rows; BatchNorm takes the global statistics (models/unet.py); each
loss is this rank's share of the global one (a weighted mean divides by
the all-reduced global weight, Dice reads all-reduced class sums); the
gradients are summed over the ranks in one flat bucket after
``backward()`` (``all_reduce_grads_``), and the returned loss and the
validation histogram are the global ones.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import LABEL_IGNORE_VAL
from ..data.device_pool import gather_crops, gather_meta_crops
from ..data.meta_channels import get_in_channels
from ..models import weights
from ..models.unet import UNet, init_train_
from ..models.weights import (flax_params_to_torch,
                              flax_to_torch_state_dict, to_tensors,
                              torch_to_flax_params, torch_to_flax_variables)
from ..ops import augment, data_ops, label_ops, metrics
from ..parallel.mesh import all_reduce_, all_reduce_grads_, all_reduce_sum
from ..utils import flax_msgpack


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the SGD
    optimizer (its momentum buffers) and the count of updates taken."""
    model: UNet
    optimizer: torch.optim.SGD
    step: int = 0


def make_lr_schedule(config: dict):
    """The staircase schedule the train step sets before each update
    (reference ExponentialLR stepped every lr_step batches)."""
    lr0 = float(config["lr"])
    rate = float(config["lr_reduction"])
    every = int(config["lr_step"])
    return lambda step: lr0 * rate ** (int(step) // every)


def make_optimizer(model: UNet, config: dict) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=float(config["lr"]),
                           momentum=float(config["momentum"]),
                           dampening=0.0, nesterov=False)


def init_train_state(model: UNet, config: dict, gen=None,
                     state_dict=None) -> TrainState:
    """Fresh TrainState at step 0.  ``state_dict`` seeds the weights from
    imported ones (e.g. a reference ``.pt`` via ``load_checkpoint``);
    otherwise ``gen`` (a ``torch.Generator``) draws torch's default
    initialisation (``init_train_``), and with neither the model keeps
    its current weights.  The momentum buffers start at zero either way
    (torch creates them at the first update as the gradient, which is
    optax's zero trace after one step)."""
    if state_dict is not None:
        dev = next(model.parameters()).device
        model.load_state_dict({k: v.to(dev) for k, v in
                               to_tensors(state_dict).items()})
    elif gen is not None:
        init_train_(model, gen)
    return TrainState(model=model, optimizer=make_optimizer(model, config))


def _one_hot(labels, valid):
    safe = torch.where(valid, labels, 0).to(torch.int64)
    return F.one_hot(safe, 3).to(torch.float32)


def _pixel_weights(oh, valid, class_weights):
    # sum(w * one_hot): exact, one term is nonzero
    w = oh[..., 0] * class_weights[0]
    for k in range(1, len(class_weights)):
        w = w + oh[..., k] * class_weights[k]
    return w * valid.to(torch.float32)


def _weighted_mean(per_pixel, pix_w, mesh):
    """``sum(per_pixel * w) / sum(w)`` over the global batch; under a mesh
    this rank's share: its numerator over the all-reduced denominator
    (which depends on the labels only and carries no gradient)."""
    denom = all_reduce_(torch.sum(pix_w).detach(), mesh)
    return torch.sum(per_pixel * pix_w) / torch.clamp(denom, min=1e-12)


def weighted_ce_loss(logits, labels, class_weights, mesh=None):
    """torch CrossEntropyLoss(weight=w) with ignore_index=-100 semantics:
    weighted mean of per-pixel NLL over non-ignored pixels (reference
    pipeline.py:132-141).  The JAX package's log-softmax + one-hot
    contraction, so a -inf logp gives NaN as there (ADVICE.md)."""
    valid = labels != LABEL_IGNORE_VAL
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    oh = _one_hot(labels, valid)
    nll = -torch.sum(logp * oh, dim=-1)
    return _weighted_mean(nll, _pixel_weights(oh, valid, class_weights),
                          mesh)


def focal_loss(logits, labels, class_weights, gamma=2.0, mesh=None):
    """Weighted focal loss (the JAX package's extension of the reference's
    documented 'Focal' option)."""
    valid = labels != LABEL_IGNORE_VAL
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    oh = _one_hot(labels, valid)
    logp_t = torch.sum(logp * oh, dim=-1)
    focal = (1.0 - torch.exp(logp_t)) ** gamma * (-logp_t)
    return _weighted_mean(focal, _pixel_weights(oh, valid, class_weights),
                          mesh)


def dice_loss(logits, labels, class_weights=None, eps=1e-6, mesh=None):
    """Soft multiclass Dice over non-ignored pixels (the JAX package's
    extension of the reference's documented 'Dice' option; it takes
    ``class_weights`` and does not use them, as there).  Under a mesh
    the per-class sums are all-reduced (differentiably) and each rank
    returns 1/N of the global loss, so the ranks' shares sum to it."""
    valid = labels != LABEL_IGNORE_VAL
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    v = valid.to(torch.float32)[..., None]
    onehot = _one_hot(labels, valid) * v
    probs = probs * v
    inter = torch.sum(probs * onehot, dim=(0, 1, 2))
    union = torch.sum(probs + onehot, dim=(0, 1, 2))
    if mesh is None:
        return 1.0 - torch.mean((2 * inter + eps) / (union + eps))
    inter, union = all_reduce_sum(torch.stack([inter, union]), mesh)
    return (1.0 - torch.mean((2 * inter + eps) / (union + eps))) / mesh.size


def make_loss_fn(config: dict, mesh=None):
    """Loss keyed on ``loss_type``: CE (the reference's only option),
    Focal, Dice, Combined (Focal + CE); under a ``mesh`` this rank's
    share of the global batch's loss."""
    loss_type = config.get("loss_type", "CE")
    w = tuple(float(v) for v in config.get("class_weights",
                                           (10.0, 300.0, 250.0)))
    if loss_type == "CE":
        return lambda logits, labels: weighted_ce_loss(logits, labels, w,
                                                       mesh=mesh)
    if loss_type == "Focal":
        return lambda logits, labels: focal_loss(logits, labels, w,
                                                 mesh=mesh)
    if loss_type == "Dice":
        return lambda logits, labels: dice_loss(logits, labels, mesh=mesh)
    if loss_type == "Combined":
        return lambda logits, labels: (
            focal_loss(logits, labels, w, mesh=mesh)
            + weighted_ce_loss(logits, labels, w, mesh=mesh))
    raise ValueError("`loss_type` not recognized")


def _train_labels(data, labels, threshold_freq_idx):
    """Train label chain [refine, convert] (reference transforms.py:69-75)."""
    labels = label_ops.refine_label_boundary(
        data, labels, threshold_freq_idx=threshold_freq_idx)
    return label_ops.convert_label_indexing(labels)


def _test_labels(data, labels, seabed_row, overlap, threshold_freq_idx):
    """Test label chain [convert_unused, refine, mask_seabed, mask_overlap]
    (reference transforms.py:78-92)."""
    labels = label_ops.convert_label_indexing(labels,
                                              mark_unused_species=True)
    labels = label_ops.refine_label_boundary(
        data, labels, threshold_freq_idx=threshold_freq_idx)
    labels = label_ops.mask_label_seabed(labels, seabed_row)
    return label_ops.mask_label_overlap(labels, overlap)


def _model_input(config: dict):
    """-> ``inputs(data, meta)``: the (NHWC input, NHWC late meta or None)
    pair the model takes, from (B, C, H, W) data and metadata crops."""
    use_meta = get_in_channels(config.get("meta_channels")) > 0
    late = bool(config.get("late_meta_inject", False))

    def inputs(data, meta):
        x = data.permute(0, 2, 3, 1)
        if not use_meta:
            return x, None
        m = meta.permute(0, 2, 3, 1)
        if late:
            return x, m
        return torch.cat([x, m], dim=-1), None

    return inputs


def make_train_step(config: dict, mesh=None):
    """-> ``train_step(state, data, labels, gen, meta=None)``: data
    (B, C, H, W) raw sv float32, labels (B, H, W) raw int32 codes, ``gen``
    the augmentation's device generator, ``meta`` the (B, M, H, W) float32
    metadata crops when the config has metadata channels.  Updates
    ``state`` in place and returns the loss (a device scalar).  Under a
    ``mesh`` the batch is this rank's rows of the global batch and the
    loss returned is the global one."""
    loss_fn = make_loss_fn(config, mesh)
    lr_at = make_lr_schedule(config)
    inputs = _model_input(config)
    use_meta = get_in_channels(config.get("meta_channels")) > 0
    # the global batch's draws, this rank's rows
    shard = {} if mesh is None else {"shard": (mesh.rank, mesh.size)}

    def train_step(state: TrainState, data, labels, gen, meta=None):
        # augment looked up at call time: tests replace it by the identity
        if use_meta:
            data, meta, labels = augment.augment_train_meta(
                gen, data, meta, labels, **shard)
        else:
            data, labels = augment.augment_train(gen, data, labels, **shard)
        labels = _train_labels(data, labels, -1)
        data, labels = data_ops.data_transform_train(data, labels,
                                                     scaled=use_meta)
        model, opt = state.model, state.optimizer
        model.train()
        for group in opt.param_groups:
            group["lr"] = lr_at(state.step)
        x, m = inputs(data, meta)
        loss = loss_fn(model(x, meta=m, mesh=mesh), labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(model, mesh)
        opt.step()
        state.step += 1
        return all_reduce_(loss.detach(), mesh)

    return train_step


def _pool_gather(config: dict):
    """-> ``gather(pool_data, pool_labels, ech_idx, starts, meta_vectors,
    flags)``: the (data, labels, meta) crops on the device, meta None
    without metadata channels."""
    window = tuple(config["patch_size"])
    use_meta = get_in_channels(config.get("meta_channels")) > 0

    def gather(pool_data, pool_labels, ech_idx, starts, meta_vectors, flags):
        data, labels = gather_crops(pool_data, pool_labels, ech_idx, starts,
                                    window)
        meta = gather_meta_crops(*meta_vectors, ech_idx, starts, window,
                                 flags) if use_meta else None
        return data, labels, meta

    return gather


def make_train_step_pooled(config: dict, mesh=None):
    """The train step over a device sample pool (data/device_pool.py):
    ``train_step(state, pool_data, pool_labels, ech_idx, starts, gen,
    meta_vectors=None, flags=())``, the pool's metadata vectors and flags
    with metadata channels; gathers the crops (and the metadata crops) on
    the device, then runs :func:`make_train_step`'s step."""
    gather = _pool_gather(config)
    base = make_train_step(config, mesh)

    def train_step(state, pool_data, pool_labels, ech_idx, starts, gen,
                   meta_vectors=None, flags=()):
        data, labels, meta = gather(pool_data, pool_labels, ech_idx, starts,
                                    meta_vectors, flags)
        return base(state, data, labels, gen, meta=meta)

    return train_step


def make_eval_step(config: dict, mesh=None):
    """-> ``eval_step(model, hist, data, labels, seabed_row, overlap=0,
    with_loss=True, meta=None)``: the validation step on raw crops (label
    test chain, data test chain, eval forward, loss on ignore-collapsed
    labels, PR histogram update into ``hist`` in place), ``meta`` the
    metadata crops with metadata channels.  Returns ``(hist, loss)``.
    Under a ``mesh`` the loss is the global batch's and ``hist`` holds
    this rank's counts: the caller sums it over the ranks
    (``all_reduce_``) before reading a curve from it."""
    loss_fn = make_loss_fn(config, mesh)
    inputs = _model_input(config)
    use_meta = get_in_channels(config.get("meta_channels")) > 0

    @torch.no_grad()
    def eval_step(model, hist, data, labels, seabed_row, overlap=0,
                  with_loss=True, meta=None):
        labels_t = _test_labels(data, labels, seabed_row, overlap, -1)
        data_t, labels_t = data_ops.data_transform_test(data, labels_t,
                                                        scaled=use_meta)
        model.eval()
        x, m = inputs(data_t, meta)
        logits = model(x, meta=m)
        probs = torch.softmax(logits, dim=-1)
        loss = torch.zeros((), device=logits.device)
        if with_loss:
            loss = all_reduce_(loss_fn(
                logits, label_ops.set_label_ignore_val(labels_t)), mesh)
        metrics.update_pr_histogram(hist, probs[..., 1], labels_t)
        return hist, loss

    return eval_step


def make_eval_step_pooled(config: dict, mesh=None):
    """The validation step over a device sample pool: ``eval_step(model,
    hist, pool_data, pool_labels, ech_idx, starts, seabed_row, overlap=0,
    with_loss=True, meta_vectors=None, flags=())``; the seabed rows stay
    host-computed."""
    gather = _pool_gather(config)
    base = make_eval_step(config, mesh)

    def eval_step(model, hist, pool_data, pool_labels, ech_idx, starts,
                  seabed_row, overlap=0, with_loss=True, meta_vectors=None,
                  flags=()):
        data, labels, meta = gather(pool_data, pool_labels, ech_idx, starts,
                                    meta_vectors, flags)
        return base(model, hist, data, labels, seabed_row, overlap=overlap,
                    with_loss=with_loss, meta=meta)

    return eval_step


# ------------------------------------------------------------- checkpoints
def momentum_buffers(state: TrainState) -> dict:
    """Reference-named SGD momentum buffers (zeros before the first
    update)."""
    out = {}
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        out[name] = torch.zeros_like(p) if buf is None else buf
    return out


def checkpoint_payload(state: TrainState) -> dict:
    """The JAX package's TrainState checkpoint tree (numpy leaves)."""
    variables = torch_to_flax_variables(state.model.state_dict())
    step = np.asarray(state.step, np.int32)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {
                "0": {"trace": torch_to_flax_params(momentum_buffers(state))},
                "1": {"count": step}},
            "step": step}


def save_checkpoint(path, state_or_vars, extras=None) -> None:
    """Write a TrainState, or plain weights (flax ``{"params",
    "batch_stats"}`` variables or a reference state dict), as a flax
    msgpack checkpoint, atomically (temp file + os.replace: a crash
    mid-write never destroys the previous good checkpoint).  ``extras``
    (e.g. the best validation F1) goes to the
    ``<path>.json`` sidecar FIRST, so a crash between the two replaces
    pairs the old checkpoint with the new (>= actual) best-F1 high-water
    mark, never a new checkpoint with a stale low one."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if extras is not None:
        with open(path + ".json.tmp", "w") as f:
            json.dump(extras, f)
        os.replace(path + ".json.tmp", path + ".json")
    if isinstance(state_or_vars, TrainState):
        payload = checkpoint_payload(state_or_vars)
    elif "params" in state_or_vars:
        payload = {k: _numpy_tree(v) for k, v in state_or_vars.items()}
    else:
        payload = torch_to_flax_variables(state_or_vars)
    data = flax_msgpack.packb(payload)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def load_checkpoint(path, template=None):
    """A checkpoint's weights as a reference state dict of CPU tensors (a
    reference ``.pt`` or either package's msgpack,
    ``models.weights.load_checkpoint``); with a TrainState ``template``
    the whole msgpack TrainState (weights, momentum, step) restored into
    it, as the JAX package restores into its template."""
    if template is None:
        return weights.load_checkpoint(path)
    return restore_train_state(template,
                               weights.read_msgpack_checkpoint(path))


def load_checkpoint_extras(path) -> dict:
    """The scalar sidecar written by :func:`save_checkpoint` (empty when
    absent)."""
    sidecar = str(path) + ".json"
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return {}


def restore_train_state(state: TrainState, payload: dict) -> TrainState:
    """Load a TrainState checkpoint tree into ``state``: weights and
    BatchNorm statistics, the momentum buffers from optax's trace, and
    the step."""
    dev = next(state.model.parameters()).device
    sd = to_tensors(flax_to_torch_state_dict(payload))
    state.model.load_state_dict({k: v.to(dev) for k, v in sd.items()},
                                strict=True)
    trace = flax_params_to_torch(payload["opt_state"]["0"]["trace"])
    for name, p in state.model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = \
            torch.from_numpy(trace[name]).to(dev)
    state.step = int(np.asarray(payload["step"]))
    return state
