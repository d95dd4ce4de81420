"""Train-mode BatchNorm + ReLU of the U-Net as one autograd op.

``bn_relu_train(z, bn, mesh)`` is ``torch.relu(_bn_train(z, bn,
z.dtype, mesh))`` of models/unet.py, flax's law: float32 batch
statistics (mean and the fast biased variance ``max(0, E[z^2] -
E[z]^2)``), running statistics ``BN_MOMENTUM * running + (1 -
BN_MOMENTUM) * batch`` updated in place, the output ``relu(T((float(z)
- mean) * mul + beta))`` with ``mul = rsqrt(var + eps) * gamma``.  Under
a data mesh the stacked ``[E[z], E[z^2]]`` is averaged over the ranks
(``all_reduce_sum / size``), as ``_bn_train`` does.

Its forward and backward compose four operators of the ``crimac::``
namespace (ops/cuda_lib.py ``define_op``), on the (M, C) rows of the
channels_last activation (M = N * H * W), dense: row r at ``r * C``:

* ``bn_relu_stats(z)`` -> ``[sum(z) / M, sum(z^2) / M]`` (2, C) float32;
* ``bn_relu_apply(z, stats, ...)`` -> the output; the running statistics
  updated in place;
* ``bn_relu_grad_stats(dout, z, stats, ...)`` -> ``[sum(g), sum(g *
  xhat)]`` (2, C) float32 of this rank's rows, ``g`` the output's
  gradient where the output is > 0 (or NaN), ``xhat = (z - mean) * rstd``:
  the gradients of beta and gamma;
* ``bn_relu_grad_apply(dout, z, stats, ..., sums, inv_m)`` -> ``dz =
  T(mul * ((g - sums[0] / M) - xhat * sums[1] / M))``, the last term 0
  where the variance's clamp is active (torch.clamp passes no gradient
  there).  Under a mesh the sums are all-reduced first and M is the global
  batch's rows, which is what autograd through ``_AllReduceSum`` gives;
  the parameter gradients stay this rank's for ``all_reduce_grads_``.

CUDA tensors launch the kernels of ``csrc/bn_relu.cu`` (two a layer
forward, two backward); CPU tensors take the plain PyTorch versions below,
the same law.  The backward saves only ``z`` and the per-channel vectors
and recomputes the ReLU's mask and ``xhat``: no float32 activation is
kept.
"""

from __future__ import annotations

import torch

from . import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)
BN_MOMENTUM = 0.9      # flax's: running = m * running + (1 - m) * batch
THREADS = 256          # csrc/bn_relu.cu kThreads
MAX_GROUPS = 32        # channel groups a tile: 256 channels at V = 8
BLOCKS_PER_SM = 4      # row blocks x channel tiles ~ this many per SM
TAIL = 65536           # partials a tile's last block sums, at most
MAX_TILES = 4096       # counters a stream keeps

_plans: dict[tuple[int, int, int, int], tuple[int, ...]] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def launch_geometry(M: int, C: int, vec: int, sms: int) -> tuple[int, int]:
    """``(gt, row_blocks)``: channel groups of ``vec`` channels a tile
    (``THREADS // gt`` rows at a time) and row blocks, so that row blocks x
    tiles is about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs while
    every row thread has a row, and a tile's last block sums at most
    ``TAIL`` partials (2 x its channels a row block) unless that leaves
    fewer blocks than SMs."""
    groups = C // vec
    gt = min(groups, MAX_GROUPS)
    tiles = -(-groups // gt)
    rows = THREADS // gt
    tail = max(-(-sms // tiles), TAIL // (2 * gt * vec))
    row_blocks = max(1, min(-(-BLOCKS_PER_SM * sms // tiles),
                            -(-M // rows), tail))
    return gt, row_blocks


def _plan(z: torch.Tensor, *others: torch.Tensor) -> tuple[int, ...]:
    """``(M, C, vec, gt, row_blocks)`` of a launch over the (M, C) rows
    ``z`` (and ``others`` of its shape), kept by shape, vector width and
    card."""
    if not all(t.is_contiguous() for t in (z, *others)):
        raise ValueError("bn_relu's kernels read dense (M, C) rows")
    M, C = z.shape
    vec = cuda_lib.vec_width(C, z, *others)
    key = (M, C, vec, z.device.index)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(
            z.device).multi_processor_count
        gt, row_blocks = launch_geometry(M, C, vec, sms)
        if -(-(C // vec) // gt) > MAX_TILES:
            raise ValueError(f"bn_relu takes at most {MAX_TILES * gt * vec}"
                             f" channels, got {C}")
        plan = _plans[key] = (M, C, vec, gt, row_blocks)
    return plan


def _counter(z: torch.Tensor, stream: int) -> torch.Tensor:
    """The stream's tile counters: zero between launches (each reduction's
    last block resets its tile's), so kernels on one stream share them."""
    key = (z.device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(MAX_TILES, dtype=torch.int32,
                                     device=z.device)
    return _counters[key]


def _code(z: torch.Tensor) -> int:
    return cuda_lib.DTYPE_CODES[z.dtype]


def _stats_cuda(z):
    M, C, vec, gt, row_blocks = _plan(z)
    stats = z.new_empty((2, C), dtype=torch.float32)
    partial = z.new_empty((row_blocks, 2, C), dtype=torch.float32)
    stream = cuda_lib.stream_of(z)
    err = cuda_lib.lib().crimac_bn_relu_stats(
        z.data_ptr(), partial.data_ptr(), _counter(z, stream).data_ptr(),
        stats.data_ptr(), _code(z), M, C, vec, gt, row_blocks, 1.0 / M,
        stream)
    cuda_lib.check(err, "bn_relu_stats")
    cuda_lib.launches["bn_relu_stats"] += 1
    return stats


def _apply_cuda(z, stats, weight, bias, running_mean, running_var, eps):
    y = torch.empty_like(z)
    M, C, vec, gt, row_blocks = _plan(z, y)
    err = cuda_lib.lib().crimac_bn_relu_apply(
        z.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
        _code(z), M, C, vec, gt, row_blocks, eps, BN_MOMENTUM,
        1 - BN_MOMENTUM, cuda_lib.stream_of(z))
    cuda_lib.check(err, "bn_relu_apply")
    cuda_lib.launches["bn_relu_apply"] += 1
    return y


def _grad_stats_cuda(dout, z, stats, weight, bias, eps):
    M, C, vec, gt, row_blocks = _plan(z, dout)
    sums = z.new_empty((2, C), dtype=torch.float32)
    partial = z.new_empty((row_blocks, 2, C), dtype=torch.float32)
    stream = cuda_lib.stream_of(z)
    err = cuda_lib.lib().crimac_bn_relu_grad_stats(
        dout.data_ptr(), z.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), partial.data_ptr(), _counter(z, stream).data_ptr(),
        sums.data_ptr(), _code(z), M, C, vec, gt, row_blocks, eps, stream)
    cuda_lib.check(err, "bn_relu_grad_stats")
    cuda_lib.launches["bn_relu_grad_stats"] += 1
    return sums


def _grad_apply_cuda(dout, z, stats, weight, bias, sums, eps, inv_m):
    dz = torch.empty_like(z)
    M, C, vec, gt, row_blocks = _plan(z, dout, dz)
    err = cuda_lib.lib().crimac_bn_relu_grad_apply(
        dout.data_ptr(), z.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), sums.data_ptr(), dz.data_ptr(), _code(z), M, C,
        vec, gt, row_blocks, eps, inv_m, cuda_lib.stream_of(z))
    cuda_lib.check(err, "bn_relu_grad_apply")
    cuda_lib.launches["bn_relu_grad_apply"] += 1
    return dz


def _channels(stats, weight, eps):
    """mean, var, rstd, mul and the clamp's pass mask (flax's order)."""
    mean = stats[0]
    d = stats[1] - mean * mean
    var = torch.clamp(d, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return mean, var, rstd, rstd * weight, d >= 0


def _relu_grad(dout, z, mean, mul, bias):
    """(g, z - mean): the output's gradient where the recomputed output is
    > 0 (or NaN), float32."""
    c = z.float() - mean
    y = (c * mul + bias).to(z.dtype)
    return torch.where(y <= 0, 0.0, dout.float()), c


def stats_reference(z):
    """Plain version of ``crimac::bn_relu_stats``."""
    zf = z.float()
    return torch.stack([zf.mean(0), (zf * zf).mean(0)])


def apply_reference(z, stats, weight, bias, running_mean, running_var, eps):
    """Plain version of ``crimac::bn_relu_apply``."""
    mean, var, _, mul, _ = _channels(stats, weight, eps)
    running_mean.mul_(BN_MOMENTUM).add_(mean * (1 - BN_MOMENTUM))
    running_var.mul_(BN_MOMENTUM).add_(var * (1 - BN_MOMENTUM))
    return torch.relu(((z.float() - mean) * mul + bias).to(z.dtype))


def grad_stats_reference(dout, z, stats, weight, bias, eps):
    """Plain version of ``crimac::bn_relu_grad_stats``."""
    mean, _, rstd, mul, _ = _channels(stats, weight, eps)
    g, c = _relu_grad(dout, z, mean, mul, bias)
    return torch.stack([g.sum(0), (g * c).sum(0) * rstd])


def grad_apply_reference(dout, z, stats, weight, bias, sums, eps, inv_m):
    """Plain version of ``crimac::bn_relu_grad_apply``."""
    mean, _, rstd, mul, passes = _channels(stats, weight, eps)
    g, c = _relu_grad(dout, z, mean, mul, bias)
    b = torch.where(passes, sums[1] * inv_m, 0.0)
    return (mul * (g - sums[0] * inv_m - c * rstd * b)).to(z.dtype)


def _sums_like(z, *rest):
    return z.new_empty((2, z.shape[1]), dtype=torch.float32)


_STATS = cuda_lib.define_op(
    "bn_relu_stats(Tensor z) -> Tensor", _stats_cuda, stats_reference,
    _sums_like)
_APPLY = cuda_lib.define_op(
    "bn_relu_apply(Tensor z, Tensor stats, Tensor weight, Tensor bias, "
    "Tensor(a!) running_mean, Tensor(b!) running_var, float eps) -> "
    "Tensor", _apply_cuda, apply_reference,
    lambda z, *rest: torch.empty_like(z))
_GRAD_STATS = cuda_lib.define_op(
    "bn_relu_grad_stats(Tensor dout, Tensor z, Tensor stats, Tensor weight, "
    "Tensor bias, float eps) -> Tensor", _grad_stats_cuda,
    grad_stats_reference, lambda dout, z, *rest: _sums_like(z))
_GRAD_APPLY = cuda_lib.define_op(
    "bn_relu_grad_apply(Tensor dout, Tensor z, Tensor stats, Tensor weight, "
    "Tensor bias, Tensor sums, float eps, float inv_m) -> Tensor",
    _grad_apply_cuda, grad_apply_reference,
    lambda dout, z, *rest: torch.empty_like(z))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> its dense (N * H * W, C) rows: a view of a dense
    channels_last tensor, else a copy (a channel slice of a wider tensor,
    as a ``torch.cat``'s backward hands on, has rows further apart)."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).contiguous()


class _BnReluTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, weight, bias, bn, mesh):
        N, C, H, W = z.shape
        x = _rows(z)
        stats = _STATS(x)
        if mesh is not None:
            from ..parallel.mesh import all_reduce_sum
            stats = all_reduce_sum(stats, mesh) / mesh.size
        y = _APPLY(x, stats, weight, bias, bn.running_mean, bn.running_var,
                   bn.eps)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.eps, ctx.mesh = bn.eps, mesh
        return y.view(N, H, W, C).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, dy):
        x, stats, weight, bias = ctx.saved_tensors
        N, C, H, W = dy.shape
        d = _rows(dy if dy.dtype == x.dtype else dy.to(x.dtype))
        sums = _GRAD_STATS(d, x, stats, weight, bias, ctx.eps)
        total, m = sums, x.shape[0]
        if ctx.mesh is not None:
            from ..parallel.mesh import all_reduce_sum
            total, m = all_reduce_sum(sums, ctx.mesh), m * ctx.mesh.size
        dz = _GRAD_APPLY(d, x, stats, weight, bias, total, ctx.eps, 1.0 / m)
        return (dz.view(N, H, W, C).permute(0, 3, 1, 2), sums[1], sums[0],
                None, None)


def bn_relu_train(z: torch.Tensor, bn: torch.nn.BatchNorm2d,
                  mesh=None) -> torch.Tensor:
    """``relu(flax train-mode BatchNorm(z))`` of a (N, C, H, W) activation
    (channels_last memory is read in place), in ``z``'s dtype; ``bn``'s
    running statistics are updated in place; ``mesh`` the data mesh whose
    global batch the statistics are taken over (parallel/mesh.py)."""
    if z.dim() != 4 or z.numel() == 0:
        raise ValueError(f"bn_relu_train takes a non-empty (N, C, H, W) "
                         f"tensor, got shape {tuple(z.shape)}")
    if z.dtype not in _DTYPES:
        raise ValueError(f"bn_relu_train takes {_DTYPES}, got {z.dtype}")
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(p.dtype != torch.float32 or p.shape != (z.shape[1],)
           for p in params):
        raise ValueError(f"bn_relu_train needs float32 ({z.shape[1]},) "
                         "BatchNorm parameters and statistics")
    cuda_lib.require_device(z, *params)
    return _BnReluTrain.apply(z, bn.weight, bn.bias, bn, mesh)
