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
written atomically with the ``<path>.json`` sidecar first.  A ``.pt``
path holds the port's own format instead, a ``torch.save`` of a
TrainState's ``{"architecture", "state_dict", "momentum", "step"}`` (of
plain weights: their state dict), the only one a SegFormer has (the JAX
package has no SegFormer tree); ``models.weights.load_checkpoint`` reads
both.  A step
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
from ..models import init_train_, weights
from ..models.segformer import SegFormer
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
    model: torch.nn.Module
    optimizer: torch.optim.SGD
    step: int = 0


def make_lr_schedule(config: dict):
    """The staircase schedule the train step sets before each update
    (reference ExponentialLR stepped every lr_step batches)."""
    lr0 = float(config["lr"])
    rate = float(config["lr_reduction"])
    every = int(config["lr_step"])
    return lambda step: lr0 * rate ** (int(step) // every)


def make_optimizer(model: torch.nn.Module, config: dict) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=float(config["lr"]),
                           momentum=float(config["momentum"]),
                           dampening=0.0, nesterov=False)


def init_train_state(model: torch.nn.Module, config: dict, gen=None,
                     state_dict=None) -> TrainState:
    """Fresh TrainState at step 0.  ``state_dict`` seeds the weights from
    imported ones (e.g. a reference ``.pt`` via ``load_checkpoint``);
    otherwise ``gen`` (a ``torch.Generator``) draws the model's training
    initialisation (``models.init_train_``), and with neither the model keeps
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


class StepGraph:
    """A train step's forward, loss and backward as one CUDA graph.

    Captured at the first call for a model and input shapes, replayed at
    every call after: the host enqueues one launch where the eager step
    enqueues each of the model's operators (SegFormer MiT-B2: ~3500 a
    step, whose enqueue takes longer than the card's work).  The same
    kernels on the same data, so the step computes what the eager step
    does.  The capture warms up on a side stream first (workspaces, the
    kernels' first builds) and then puts the model's buffers (BatchNorm's
    running statistics) back, so they move once a call, as eagerly.  The
    gradients are the graph's own tensors, handed to the parameters'
    ``.grad`` at every call.  Host-side effects of the forward (profiler
    ranges, ``attn_pairs``) happen at the capture only."""

    WARM = 3

    def __init__(self):
        self.key = None

    def __call__(self, model, loss_fn, x, labels):
        key = (model, x.shape, x.dtype, labels.shape, labels.dtype)
        if key != self.key:
            self._capture(model, loss_fn, x, labels)
            self.key = key
        self.x.copy_(x)
        self.labels.copy_(labels)
        self.graph.replay()
        for p, g in self.grads:
            p.grad = g
        return self.loss.clone()

    def _capture(self, model, loss_fn, x, labels):
        self.graph = self.grads = None
        params = [p for p in model.parameters() if p.requires_grad]
        saved = [b.clone() for b in model.buffers()]
        self.x, self.labels = x.clone(), labels.clone()

        def step():
            loss = loss_fn(model(self.x), self.labels)
            return loss, torch.autograd.grad(loss, params,
                                             allow_unused=True)

        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARM):
                step()
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # other threads (the batch prefetch) go on using the device
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.loss, grads = step()
        self.grads = list(zip(params, grads))
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)


def make_train_step(config: dict, mesh=None):
    """-> ``train_step(state, data, labels, gen, meta=None)``: data
    (B, C, H, W) raw sv float32, labels (B, H, W) raw int32 codes, ``gen``
    the augmentation's device generator, ``meta`` the (B, M, H, W) float32
    metadata crops when the config has metadata channels.  Updates
    ``state`` in place and returns the loss (a device scalar).  Under a
    ``mesh`` the batch is this rank's rows of the global batch and the
    loss returned is the global one.  The model takes ``gen`` after the
    augmentation for its stochastic layers (SegFormer's drop-path and
    dropout; the U-Net has none).

    ``train_graph: true`` runs the forward, loss and backward on a CUDA
    device as one :class:`StepGraph` (elsewhere eagerly, the same step);
    the augmentation, the label and data chains and the SGD update stay
    eager.  It takes a single-device step without metadata channels, of
    a model that draws no masks."""
    use_meta = get_in_channels(config.get("meta_channels")) > 0
    graph = None
    if config.get("train_graph", False):
        if mesh is not None or use_meta:
            raise ValueError("train_graph takes a single-device train step "
                             "without metadata channels")
        graph = StepGraph()
    loss_fn = make_loss_fn(config, mesh)
    lr_at = make_lr_schedule(config)
    inputs = _model_input(config)
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
        if graph is not None and getattr(model, "stochastic", False):
            raise ValueError("train_graph takes a model that draws no masks:"
                             " set drop_path_rate and "
                             "classifier_dropout_prob to 0")
        if graph is not None and x.is_cuda:
            loss = graph(model, loss_fn, x, labels)
        else:
            loss = loss_fn(model(x, meta=m, mesh=mesh, gen=gen), labels)
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


def _cpu(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def torch_payload(state_or_vars) -> dict:
    """The port's ``.pt`` checkpoint of a TrainState (architecture,
    weights, momentum, step); plain weights are their state dict."""
    if not isinstance(state_or_vars, TrainState):
        return _cpu(state_or_vars)
    return {"architecture": _model_architecture(state_or_vars.model),
            "state_dict": _cpu(state_or_vars.model.state_dict()),
            "momentum": _cpu(momentum_buffers(state_or_vars)),
            "step": int(state_or_vars.step)}


def _model_architecture(model) -> str:
    return "segformer" if isinstance(model, SegFormer) else "unet"


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
    mark, never a new checkpoint with a stale low one.  A ``.pt`` path
    takes the port's own format (:func:`torch_payload`)."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if extras is not None:
        with open(path + ".json.tmp", "w") as f:
            json.dump(extras, f)
        os.replace(path + ".json.tmp", path + ".json")
    if path.endswith(".pt"):
        with open(path + ".tmp", "wb") as f:
            torch.save(torch_payload(state_or_vars), f)
        os.replace(path + ".tmp", path)
        return
    if isinstance(state_or_vars, TrainState):
        if isinstance(state_or_vars.model, SegFormer):
            raise ValueError("a SegFormer checkpoint is the port's .pt "
                             "file: the JAX package has no SegFormer tree")
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
    if str(path).endswith(".pt"):
        return restore_torch_train_state(template, read_train_state(path))
    return restore_train_state(template,
                               weights.read_msgpack_checkpoint(path))


def read_train_state(path):
    """A ``.pt`` TrainState checkpoint of the port, or None where the file
    is missing or holds weights alone (a reference state dict)."""
    if not os.path.isfile(str(path)):
        return None
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    return payload if "momentum" in payload else None


def restore_torch_train_state(state: TrainState, payload) -> TrainState:
    """Load the port's ``.pt`` TrainState checkpoint into ``state``."""
    if payload is None:
        raise ValueError("the .pt file holds no training state (weights "
                         "alone): it cannot seed a TRAINING resume")
    want = _model_architecture(state.model)
    if payload["architecture"] != want:
        raise ValueError(f"the checkpoint is a {payload['architecture']}'s;"
                         f" the config builds a {want}")
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(
        {k: v.to(dev) for k, v in payload["state_dict"].items()},
        strict=True)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = \
            payload["momentum"][name].to(dev)
    state.step = int(payload["step"])
    return state


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
