"""``bn_relu_train`` (ops/bn_relu.py), the train step's BatchNorm + ReLU,
on the CPU: its operators' plain versions composed by its autograd
function, held to ``torch.relu(_bn_train(...))`` (models/unet.py, flax's
law) under autograd.

Tolerances: the output, the running statistics and the gradients of
gamma and beta bit-equal (the same float32 operations in the same order);
the gradient of z within one ulp of its dtype at its magnitude plus 1e-6
of the largest (the backward's formula is autograd's, summed in another
order).  The data mesh runs as two ranks in two threads whose all-reduce
sums in rank order; there the statistics of two halves differ from the
whole batch's in the last bits, so the output too is held within that
tolerance.  The CUDA kernels' launch geometry is checked here, the
kernels themselves on the card (tests/test_torch_gpu.py).
"""

import threading

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.models import unet as U
from crimac_unet_tpu_torch.models.unet import (_bn_train, build_unet,
                                               init_train_)
from crimac_unet_tpu_torch.ops import bn_relu as B
from crimac_unet_tpu_torch.ops import cuda_lib
from crimac_unet_tpu_torch.parallel import mesh as pmesh

DTYPES = [torch.float32, torch.bfloat16]


def _bn(C, seed=3):
    bn = torch.nn.BatchNorm2d(C)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g) + .5)
        bn.bias.copy_(torch.rand(C, generator=g) - .5)
        bn.running_mean.copy_(torch.rand(C, generator=g) - .5)
        bn.running_var.copy_(torch.rand(C, generator=g) + .5)
    return bn


def _cl(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _clamped(z):
    """Per channel: the float32 ``E[z^2] - E[z]^2`` is negative, so the
    variance's clamp is active."""
    return ~B._channels(B.stats_reference(B._rows(z)), 1.0, 1e-5)[4]


def _inputs(case, C, dtype):
    """(z, cotangent), channels_last; in the ``clamp`` case channel 0
    holds a constant whose float32 statistics reach the clamp."""
    N, H, W = {"batch": (3, 7, 5), "batch1": (1, 6, 4),
               "clamp": (7, 11, 13)}[case]
    rng = np.random.RandomState(C)
    z = rng.randn(N, C, H, W).astype(np.float32) * 2 + .5
    ct = _cl(rng.randn(N, C, H, W).astype(np.float32), dtype)
    if case != "clamp":
        return _cl(z, dtype), ct
    for v in np.geomspace(0.1, 50, 400):
        z[:, 0] = v
        zt = _cl(z, dtype)
        if bool(_clamped(zt)[0]):
            return zt, ct
    raise AssertionError("no constant channel reaches the clamp")


def _assert_ulp_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    bits = {torch.float32: 24, torch.bfloat16: 8}[want.dtype]
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - bits)
    tol = ulp + 1e-6 * float(w.abs().max())
    assert torch.all((g - w).abs() <= tol), float((g - w).abs().max())


def _law(z, bn, mesh=None):
    return torch.relu(_bn_train(z, bn, z.dtype, mesh))


def _op(z, bn, mesh=None):
    return B.bn_relu_train(z, bn, mesh)


@pytest.mark.parametrize("case", ["batch", "batch1", "clamp"])
@pytest.mark.parametrize("C", [4, 12, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_relu_train_matches_bn_train_and_relu(dtype, C, case):
    z0, ct = _inputs(case, C, dtype)
    out = {}
    for name, fn in (("law", _law), ("op", _op)):
        bn = _bn(C)
        z = z0.clone().requires_grad_(True)
        y = fn(z, bn)
        y.backward(ct)
        out[name] = (y.detach(), bn.running_mean, bn.running_var,
                     bn.weight.grad, bn.bias.grad, z.grad)
    (y0, m0, v0, dg0, db0, dz0), (y1, m1, v1, dg1, db1, dz1) = \
        out["law"], out["op"]
    assert y1.dtype == dtype and torch.equal(y1, y0)
    assert torch.equal(m1, m0) and torch.equal(v1, v0)
    assert torch.equal(dg1, dg0) and torch.equal(db1, db0)
    _assert_ulp_close(dz1, dz0)
    assert bool(_clamped(z0)[0]) == (case == "clamp")


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_channel_slice_cotangent_reaches_the_ops_as_dense_rows(
        dtype, monkeypatch):
    """A ``torch.cat([y, m], dim=1)`` after the op (the late metadata
    inject) hands its backward a channel slice of a wider channels_last
    gradient, whose rows lie C + 1 apart: the operators get dense rows
    (the kernels read row r at r * C), and the gradients are those of a
    dense cotangent."""
    z0, _ = _inputs("batch", 8, dtype)
    wide = _cl(np.random.RandomState(5).randn(3, 9, 7, 5).astype(
        np.float32), dtype)
    seen = []
    for name in ("_GRAD_STATS", "_GRAD_APPLY"):
        real = getattr(B, name)

        def spy(d, *rest, real=real):
            seen.append(d.is_contiguous())
            return real(d, *rest)
        monkeypatch.setattr(B, name, spy)
    grads = []
    for dense in (False, True):
        bn = _bn(8)
        z = z0.clone().requires_grad_(True)
        y = torch.cat([_op(z, bn), torch.zeros_like(z[:, :1])], dim=1)
        ct = wide.contiguous(memory_format=torch.channels_last) \
            if dense else wide
        y.backward(ct)
        grads.append((z.grad, bn.weight.grad, bn.bias.grad))
    assert seen == [True] * 4
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_strided_rows_are_refused_by_the_kernels_plan():
    """The kernels' launch plan takes dense (M, C) rows only."""
    wide = torch.zeros((10, 9), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dense"):
        B._plan(wide[:, :8])


@pytest.mark.parametrize("dtype", DTYPES)
def test_output_keeps_the_channels_last_layout(dtype):
    """The op reads a channels_last map in place and hands back a
    channels_last map; a contiguous NCHW input is copied, same values."""
    z, _ = _inputs("batch", 8, dtype)
    y = _op(z, _bn(8))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_op(z.contiguous(), _bn(8)), y)


def _two_rank_all_reduce(monkeypatch):
    """``dist.all_reduce`` for two ranks that are two threads: each
    thread's tensor becomes the rank-ordered sum."""
    slots, local = [None, None], threading.local()
    barrier = threading.Barrier(2)

    def all_reduce(t, group=None):
        slots[local.rank] = t.clone()
        barrier.wait()
        total = slots[0] + slots[1]
        barrier.wait()
        t.copy_(total)

    monkeypatch.setattr(pmesh.dist, "all_reduce", all_reduce)
    return local


@pytest.mark.parametrize("dtype", DTYPES)
def test_mesh_of_two_ranks_equals_the_whole_batch(dtype, monkeypatch):
    """Two ranks, each half the batch under a mesh of two: the forward's
    statistics and the backward's two sums are the global batch's, so
    each rank's output and dz are its half of the one-process op's on the
    whole batch, the running statistics are the whole batch's on both
    ranks, and the ranks' gamma and beta gradients sum to the whole
    batch's; ``_bn_train`` through ``_AllReduceSum`` gives the same."""
    local = _two_rank_all_reduce(monkeypatch)
    z0, ct = _inputs("batch", 12, dtype)
    z0, ct = torch.cat([z0, z0.flip(0) * .5]), torch.cat([ct, -ct])
    half = z0.shape[0] // 2

    def whole(fn):
        bn = _bn(12)
        z = z0.clone().requires_grad_(True)
        fn(z, bn).backward(ct)
        return z.grad, bn

    def ranks(fn):
        res, errors = [None, None], []

        def work(rank):
            try:
                local.rank = rank
                bn = _bn(12)
                sl = slice(rank * half, (rank + 1) * half)
                z = z0[sl].clone().requires_grad_(True)
                y = fn(z, bn, pmesh.Mesh(rank=rank, size=2, group=None))
                y.backward(ct[sl])
                res[rank] = (y.detach(), z.grad, bn)
            except Exception as e:           # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=work, args=(r,))
                   for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return res

    dz_w, bn_w = whole(_op)
    y_w = _op(z0, _bn(12)).detach()
    for fn in (_op, _law):
        r = ranks(fn)
        _assert_ulp_close(torch.cat([r[0][0], r[1][0]]), y_w)
        _assert_ulp_close(torch.cat([r[0][1], r[1][1]]), dz_w)
        for _, _, bn in r:
            torch.testing.assert_close(bn.running_mean, bn_w.running_mean,
                                       rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(bn.running_var, bn_w.running_var,
                                       rtol=1e-6, atol=1e-7)
        for p in ("weight", "bias"):
            total = sum(getattr(bn, p).grad for _, _, bn in r)
            torch.testing.assert_close(total, getattr(bn_w, p).grad,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet_train_step_runs_the_op_and_matches_the_law(dtype,
                                                         monkeypatch):
    """A train-mode U-Net forward and backward through ``bn_relu_train``
    against the same model with the law in its place: logits, every
    parameter's gradient and the running statistics."""
    cfg = {"depth": 3, "start_filts": 8, "compute_dtype":
           str(dtype).split(".")[1]}
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 4)
                         .astype(np.float32))
    calls = []

    def counted(y, bn, mesh=None):
        calls.append(y.shape[1])
        return B.bn_relu_train(y, bn, mesh)

    out = {}
    for name, fn in (("op", counted),
                     ("law", _law)):
        monkeypatch.setattr(U, "bn_relu_train", fn)
        net = init_train_(build_unet(cfg), torch.Generator().manual_seed(1))
        net.train()
        logits = net(x)
        logits.square().mean().backward()
        out[name] = (logits.detach(),
                     {n: p.grad for n, p in net.named_parameters()},
                     {n: b.clone() for n, b in net.named_buffers()})
    assert calls == [8, 8, 16, 16, 32, 32, 16, 16, 8, 8]
    (l0, g0, b0), (l1, g1, b1) = out["law"], out["op"]
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=2e-3, atol=2e-4,
                                   msg=n)
    for n in b0:
        assert torch.equal(b1[n], b0[n]), n


@pytest.mark.parametrize("B_, level", [(b, i) for b in (4, 16, 32)
                                       for i in range(5)])
def test_launch_geometry_fills_the_card_at_unet_shapes(B_, level):
    """At every level of the flagship U-Net (1 M rows x 64 channels at
    level 0 of b16 down to 1024 x 1024 at level 4 of b4) the grid has at
    least one block per SM of an H100 (132) and every row thread a row;
    a tile holds at most 256 channels, and gt * rows is the block."""
    M, C = B_ * (256 >> level) ** 2, 64 << level
    gt, row_blocks = B.launch_geometry(M, C, 8, 132)
    tiles = -(-(C // 8) // gt)
    rows = B.THREADS // gt
    assert gt * 8 <= 256 and gt * rows == B.THREADS
    assert row_blocks * tiles >= 132
    assert row_blocks * rows <= M
    assert row_blocks * tiles <= B.BLOCKS_PER_SM * 132 + tiles


@pytest.mark.parametrize("C, vec", [(4, 1), (12, 1), (64, 8), (1024, 8)])
def test_vector_width_follows_the_channels(C, vec):
    """16-byte accesses (8 channels a thread) where C % 8 == 0, the
    scalar path otherwise; a misaligned pointer takes the scalar path."""
    z = torch.zeros((10, C), dtype=torch.bfloat16)
    assert cuda_lib.vec_width(C, z) == vec
    if vec == 8:
        assert cuda_lib.vec_width(C, z.view(-1)[1:1 + 9 * C].view(9, C)) == 1


def test_fake_implementations_give_the_output_shapes():
    """The operators trace under fake tensors (their fake
    implementations): the sums (2, C) float32, the maps z's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        z = torch.empty((40, 12), dtype=torch.bfloat16)
        v = torch.empty(12)
        st = B._STATS(z)
        assert st.shape == (2, 12) and st.dtype == torch.float32
        y = B._APPLY(z, st, v, v, v, v, 1e-5)
        assert y.shape == z.shape and y.dtype == z.dtype
        s = B._GRAD_STATS(z, z, st, v, v, 1e-5)
        assert s.shape == (2, 12) and s.dtype == torch.float32
        dz = B._GRAD_APPLY(z, z, st, v, v, s, 1e-5, .025)
        assert dz.shape == z.shape and dz.dtype == z.dtype


def test_bad_inputs_raise():
    bn = _bn(4)
    with pytest.raises(ValueError, match="non-empty"):
        _op(torch.zeros((0, 4, 2, 2)), bn)
    with pytest.raises(ValueError, match="takes"):
        _op(torch.zeros((1, 4, 2, 2), dtype=torch.float16), bn)
    with pytest.raises(ValueError, match="BatchNorm parameters"):
        _op(torch.zeros((1, 5, 2, 2)), bn)
