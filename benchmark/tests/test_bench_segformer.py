"""The segformer architecture's adapter (``architectures/segformer.py``):
its FLOP laws against ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference, the program's ``attn_pairs`` counter against the
attention law, ``check_config``, the ``attn_*`` readers on a trace without
attention kernels, and the stop where a checkout's program has no
SegFormer.  On the CPU at a tiny size: two MiT stages (hidden 16 / 32,
head dim 16 in both) on 64 x 64 crops."""

import os
import shutil

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.reference import segformer as ref

from .conftest import ROOT

BENCH = run.load_bench()
CELL = "train_b16_512.segformer_b2"
CFG = run.cell_files(BENCH, CELL)[3]
ARCH = run.load_architecture(CFG)
TINY = dict(CFG, hidden_sizes=[16, 32], depths=[1, 2],
            num_attention_heads=[1, 2], sr_ratios=[2, 1], patch_sizes=[7, 3],
            strides=[4, 2], mlp_ratios=[4, 4], decoder_hidden_size=32,
            patch_size=[64, 64], batch_size=2, device="cpu",
            train_dtype="float32")


def _flops_by_op(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def _state_and_input():
    state = ARCH.init_state(TINY, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 4, 64, 64, generator=torch.Generator().manual_seed(1))
    return state, x


def test_forward_flops_is_the_counters_total():
    """Every conv (``aten.convolution``: patch embeddings, reductions,
    depthwise, fuse, classifier), linear (``aten.mm``) and the two
    attention products (``aten.bmm``) of one forward."""
    state, x = _state_and_input()
    got = _flops_by_op(lambda: ARCH.forward(TINY, state, x))
    assert set(got) <= {"aten.convolution", "aten.mm", "aten.bmm"}
    assert sum(got.values()) == 2 * ARCH.forward_flops(TINY, 64, 64)
    assert ARCH.train_step_flops(TINY, 2, 64, 64) == \
        3 * 2 * ARCH.forward_flops(TINY, 64, 64)


def test_attention_flops_are_the_products_of_a_step():
    """The attention law of a step: the ``aten.bmm`` FLOPs of a forward
    and its backward (2 products forward, 4 backward)."""
    state, x = _state_and_input()
    leaves = {k: v.requires_grad_(v.is_floating_point())
              for k, v in state.items()}

    def step():
        out = ARCH.forward(TINY, leaves, x, mode="train")
        out.square().mean().backward()
    got = _flops_by_op(step)
    assert got["aten.bmm"] == ARCH.attention_flops(TINY, 2, 64, 64)


def test_the_published_cell_counts():
    """At the cell's 512 x 512 crops: 121.08 GFLOP a crop forward, of it
    7.78 GFLOP of attention products; 5.81 TFLOP a batch-16 step."""
    assert ARCH.forward_flops(CFG, 512, 512) == 121079070720
    assert ARCH.train_step_flops(CFG, 16, 512, 512) == 5811795394560
    assert ARCH.attention_flops(CFG, 16, 512, 512) == 373662154752
    assert ARCH.attention_bytes(CFG, 16, 512, 512) == 1679294464


def test_the_programs_pair_counter_is_the_attention_law():
    """One train step of the port's SegFormer counts
    ``attention_flops / (12 * head_dim)`` query-key pairs."""
    from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
    sp = SegPipeUNet(TINY)
    sp.init_model(seed=0)
    sp.generator = torch.Generator().manual_seed(0)
    sp.model.take_attn_pairs()
    g = torch.Generator().manual_seed(2)
    sp.train_step({"data": torch.rand(2, 4, 64, 64, generator=g) * 1e-5,
                   "labels": torch.zeros(2, 64, 64, dtype=torch.int32)})
    assert sp.model.take_attn_pairs() == \
        ARCH.attention_flops(TINY, 2, 64, 64) // (12 * 16)


@pytest.mark.parametrize("key", sorted(ref.MIT_B2))
def test_check_config_refuses_a_changed_width(key):
    ARCH.check_config(CFG)
    v = CFG[key]
    bad = [x * 2 for x in v] if isinstance(v, list) else v * 2
    with pytest.raises(ValueError, match=key):
        ARCH.check_config(dict(CFG, **{key: bad}))


@pytest.mark.parametrize("size", [[500, 512], [512, 496], [512]])
def test_check_config_refuses_a_crop_off_the_alignment(size):
    ARCH.check_config(dict(CFG, patch_size=[256, 1024]))
    with pytest.raises(ValueError, match="multiples of 32"):
        ARCH.check_config(dict(CFG, patch_size=size))


class _NoAttention:
    def kernel_time(self, match):
        names = ["void cudnn::conv_kernel", "bn_relu_apply_kernel",
                 "elementwise_kernel"]
        return sum(1 for n in names if match(n)), 0.0


@pytest.mark.parametrize("metric", ["attn_share.train",
                                    "attn_roofline.train"])
def test_readers_read_nothing_without_attention_kernels(metric):
    ctx = {"trace": _NoAttention(), "window_s": 1.0, "busy_s": 0.5,
           "flops": 10 ** 12, "done": 16}
    assert run.load_reader(metric)(ctx) is None


class _Flash:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_time(self, match):
        names = ["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_"
                 "traits<64, 128, 128, 4>>", "void pytorch_flash::flash_bwd_"
                 "dq_dk_dv_loop_seqk_parallel_kernel<>", "elementwise"]
        hits = [n for n in names if match(n)]
        return len(hits), self.seconds if hits else 0.0


def test_readers_on_flash_kernels():
    """Two traced steps whose attention kernels took 2 ms: the share of a
    0.1 s window, and the least time of two steps' attention bytes at
    the card's bandwidth over 2 ms."""
    from benchmark.yardstick.counts import PEAK_HBM_BYTES
    ctx = {"trace": _Flash(0.002), "window_s": 0.1,
           "flops": 2 * ARCH.train_step_flops(CFG, 16, 512, 512)}
    assert run.load_reader("attn_share.train")(ctx) == pytest.approx(2.0)
    want = 100.0 * 2 * 1679294464 / PEAK_HBM_BYTES / 0.002
    assert run.load_reader("attn_roofline.train")(ctx) == \
        pytest.approx(want)


def test_a_checkout_without_the_programs_segformer_stops_at_once(
        tmp_path, monkeypatch):
    """The parent of this architecture's first PR, given its benchmark
    files: the adapter stops the run as it is loaded, naming the missing
    file, before any input is made."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    missing = os.path.join(str(root), "crimac_unet_tpu_torch", "models",
                           "segformer.py")
    monkeypatch.setattr(run, "WORK", str(tmp_path / "work"))
    with pytest.raises(SystemExit, match=missing + " does not exist"):
        run.run_cell(BENCH, CELL, 1, 0, 0, device="cpu", root=str(root))
    assert not (tmp_path / "work").exists()
