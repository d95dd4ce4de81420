"""Data parallelism over ``torch.distributed``: one process per device.

The port's counterpart of ``crimac_unet_tpu/parallel/mesh.py``.  The JAX
package runs one program over a 1-D ``Mesh('data')`` and lets XLA insert
the collectives; here every rank is its own process on its own device,
holds a full copy of the parameters, and takes rows ``[r*B/N, (r+1)*B/N)``
of each global batch.  The collectives are explicit and few: the
BatchNorm statistics and the loss denominators of a train step, one flat
gradient all-reduce after ``backward()``, the evaluation histograms, and
the all-gather of predicted probabilities.  NCCL carries them between
CUDA devices and gloo between CPU processes; the rank's device chooses.

Launch: ``torchrun --nproc_per_node N -m crimac_unet_tpu_torch.pipeline.
train ...`` (``init_distributed`` reads torchrun's environment).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D data mesh: its rank, the mesh size and
    the process group the collectives run on (the rank's device is the
    one its tensors lie on)."""
    rank: int
    size: int
    group: object


def init_distributed(init_method=None, world_size=None, rank=None,
                     device=None, backend=None, timeout_s=None) -> bool:
    """Join (or form) the process group of a multi-process run.

    Reads the explicit arguments, else torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    (``init_method`` defaults to ``env://``).  On a single host with none
    of these and without ``CRIMAC_MULTIHOST=1`` it returns False and
    touches nothing, as the JAX package's does.  Returns True once the
    process belongs to a group (idempotent).

    ``device`` is the rank's device (``cuda`` unless the caller asks for
    the CPU): a CUDA rank binds ``cuda:<LOCAL_RANK>`` (torchrun's; without
    it ``rank`` modulo the node's card count) and uses NCCL, a CPU rank
    gloo.  ``backend`` overrides that choice; a caller that sets
    it states why (two ranks on one card, where NCCL refuses)."""
    if dist.is_initialized():
        return True
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and not all(k in os.environ for k in _ENV) \
            and os.environ.get("CRIMAC_MULTIHOST") != "1":
        return False
    rank = int(os.environ["RANK"] if rank is None else rank)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a rank runs on the GPU unless the "
                "caller passes device='cpu' (CLI: --device cpu)")
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None
                                  else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kwargs = {}
    if timeout_s is not None:
        import datetime
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_mesh(n_devices: int = 0):
    """The data mesh over ``n_devices`` ranks (0 = the whole world), or
    None when this process runs alone (no process group, or
    ``n_devices == 1`` in a larger world: every rank then runs the whole
    batch by itself).

    Asking for more ranks than the world has raises instead of silently
    running a smaller mesh, as the JAX package's ``get_mesh`` does; a
    mesh is the whole world (one group per run), so a size between 1 and
    the world's raises too."""
    n = int(n_devices or 0)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        where = (f"{world} rank(s) are in the process group"
                 if dist.is_initialized() else
                 "1 process is running (no process group: launch with "
                 "torchrun --nproc_per_node N)")
        raise ValueError(f"get_mesh({n}) but only {where}; use 0 for all")
    if not dist.is_initialized() or (n == 1 and world > 1):
        return None
    if n not in (0, world):
        raise ValueError(f"get_mesh({n}) in a world of {world} ranks: a "
                         "mesh spans the whole process group (0 or "
                         f"{world})")
    return Mesh(rank=dist.get_rank(), size=world, group=dist.group.WORLD)


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else mesh.rank


def is_writer() -> bool:
    """Rank 0 of the process group (a process without one) writes
    checkpoints, stores, logs and plots.  Decided from the group, not
    from a mesh: ranks without a mesh (``mesh_devices: 1``, a batch the
    mesh does not divide) all compute the same outputs, and one writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (no-op without one)."""
    if dist.is_initialized():
        dist.barrier()


def shard_rows(mesh, x):
    """This rank's rows ``[r*B/N, (r+1)*B/N)`` of ``x`` (all of it without
    a mesh).  The caller has checked that N divides B."""
    if mesh is None:
        return x
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def checked_shard(batch: dict, mesh) -> dict:
    """This rank's rows of every array of a batch dict, after a loud
    divisibility check that names the offending key (a silent floor
    division would drop rows and skew the global batch)."""
    if mesh is None:
        return dict(batch)
    for k, v in batch.items():
        if np.ndim(v) and v.shape[0] % mesh.size:
            raise ValueError(
                f"batch[{k!r}] leading axis {v.shape[0]} is not divisible "
                f"by the {mesh.size}-rank mesh")
    return {k: shard_rows(mesh, v) if np.ndim(v) else v
            for k, v in batch.items()}


@torch.no_grad()
def replicate_(mesh, module=None, optimizer=None) -> None:
    """Broadcast a module's parameters and buffers, and an optimizer's
    state tensors, from rank 0 to every rank of ``mesh``."""
    if mesh is None:
        return
    tensors = []
    if module is not None:
        tensors += list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for st in optimizer.state.values():
            tensors += [t for t in st.values() if torch.is_tensor(t)]
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient of every rank's copy of the
    sum reaches every rank's input, so the backward sums too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable sum over the mesh (its backward sums the incoming
    gradients over the ranks); the identity without a mesh."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, mesh) -> torch.Tensor:
    """In-place sum over the mesh, outside autograd; returns ``x``."""
    if mesh is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


@torch.no_grad()
def all_gather_cat(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's equal-shaped ``x`` along ``dim`` in rank
    order (the list form of all_gather, which NCCL and gloo both take)."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def all_reduce_grads_(module, mesh) -> None:
    """Sum the parameter gradients over the mesh in one flat bucket: one
    collective per step.  The losses already divide by the global
    weight, so the sum (not the mean DDP would take) is the gradient of
    the global batch."""
    if mesh is None:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank of the process group (small host
    values: a resume point, a run directory, a validation score)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
