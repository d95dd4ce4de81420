"""The port's SegFormer (``models/segformer.py``) against the plain
reference (``benchmark/reference/segformer.py``, float32, none of the
program's code) at a tiny size on the CPU: two stages of MiT (hidden 16 /
32, one block each, heads 1 / 2, reductions 2 / 1, decoder 32) on 64 x 64
crops, on seeded random weights drawn by the reference.  Beside it: the
model on the port's paths (``build_model``, the train step and its
checkpoints, ``GriddedRunner``, BatchNorm folding) and what it refuses.

Each tolerance states its reason; each is tight enough that the
reference's fp8 control (every conv and linear input and weight rounded
to e4m3) fails it.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import segformer as ref
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import TINY_CONFIG, tiny_workload
from crimac_unet_tpu_torch.models import build_model
from crimac_unet_tpu_torch.models.fold_bn import fold_for_serving
from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
from crimac_unet_tpu_torch.models.segformer import Draws, SegFormer
from crimac_unet_tpu_torch.models.unet import build_unet, count_params
from crimac_unet_tpu_torch.models.unet import init_random_ as unet_random_
from crimac_unet_tpu_torch.pipeline import engine
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet

TINY = {"architecture": "segformer", "hidden_sizes": [16, 32],
        "depths": [1, 1], "num_attention_heads": [1, 2], "sr_ratios": [2, 1],
        "patch_sizes": [7, 3], "strides": [4, 2], "mlp_ratios": [4, 4],
        "decoder_hidden_size": 32, "drop_path_rate": 0.0,
        "classifier_dropout_prob": 0.0}
CFG = dict(TINY, frequencies=[18, 38, 120, 200], device="cpu",
           batch_size=4, lr=0.01, lr_reduction=0.5, lr_step=250,
           momentum=0.95, patch_size=[64, 64], patch_overlap=8,
           fwd_batch=8)
ARCH = ref.arch_of(CFG)


def _state(seed):
    return ref.init_state(torch.Generator().manual_seed(seed), "cpu", ARCH)


def _db(g, B=4, H=64, W=64):
    """Survey-like dB crops: mostly near the -75 dB floor."""
    sv = torch.rand(B, 4, H, W, generator=g) ** 3 * 1e-4
    return torch.clamp(10 * torch.log10(sv + 1e-10), -75.0, 0.0)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


# float32: the program's kernels sum in another order than the
# reference's plain ops (read up to 8.1e-7 over six seeds): 10x room.
# bfloat16: every conv and linear's input and weight rounded to 8 bits
# (read 0.0063-0.0165 over six seeds); the fp8 control reads 0.092-0.225
# on the same seeds.
EVAL_TOL = {"float32": 1e-5, "bfloat16": 0.05}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_against_the_reference(seed, dtype):
    state = _state(seed)
    x = _db(torch.Generator().manual_seed(100 + seed))
    ref.calibrate_bn(state, x, ARCH)
    want = ref.forward(state, x, ARCH).permute(0, 2, 3, 1)
    model = build_model(dict(CFG, compute_dtype=dtype))
    model.load_state_dict(state)
    got = model.eval()(x.permute(0, 2, 3, 1))
    assert got.shape == (4, 64, 64, 3) and got.dtype == torch.float32
    assert _gap(got, want) <= EVAL_TOL[dtype]
    control = ref.forward(state, x, ARCH, quant="fp8").permute(0, 2, 3, 1)
    assert _gap(control, want) > EVAL_TOL[dtype]


def _batches(g, n=3, B=4, H=64, W=64):
    """Raw sv crops with one labelled school each and a strip of
    boundary pixels, and their label codes."""
    out = []
    for _ in range(n):
        data = torch.rand(B, 4, H, W, generator=g) ** 4 * 1e-4
        labels = torch.zeros(B, H, W, dtype=torch.int64)
        for b in range(B):
            y, x = (int(v) for v in torch.randint(0, H - 16, (2,),
                                                  generator=g))
            labels[b, y:y + 12, x:x + 16] = 27 if b % 2 else 1
            data[b, :, y:y + 12, x:x + 16] *= 50
        labels[:, :3] = ref_train.IGNORE
        out.append((data, labels))
    return out


def _train_gaps(state, batches, losses, params):
    """The cell's check (``yardstick/train_cell.py`` ``judge``): the worst
    relative loss gap and the worst leaf's update gap against the
    reference's three steps."""
    r_losses, r_grad1, r_params = ref_train.run_steps(
        state, batches, torch.Generator().manual_seed(99), CFG,
        lambda s, x, q, mode: ref.forward(s, x, ARCH, q, mode))
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in
             r_grad1.items()}
    med = float(np.median(list(norms.values())))
    skip = {k for k, n in norms.items() if n < 1e-3 * med}
    init = {k: state[k] for k in r_params}
    return (max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            ref_train.leaf_gaps({k: params[k] - init[k] for k in r_params},
                                {k: r_params[k] - init[k]
                                 for k in r_params}, skip))


# (loss_gap, update_gap) limits.  float32: the reference's sums in
# another order (read 0 / up to 1.7e-5 over five seeds); a 1e-5 loss and
# 1e-4 update room, which the fp8 control exceeds over 300x.  bfloat16:
# read up to 0.00183 / 0.0553 over these five seeds at this size, where
# the fp8 control reads 0.00386-0.0138 / 0.0909-0.261: each limit lies
# between the two.
TRAIN_LIMITS = {"float32": (1e-5, 1e-4), "bfloat16": (0.003, 0.075)}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_against_the_reference(seed, dtype):
    g = torch.Generator().manual_seed(seed)
    state = ref.init_state(g, "cpu", ARCH)
    batches = _batches(g)
    sp = SegPipeUNet(dict(CFG, train_dtype=dtype))
    sp.init_model(state_dict={k: v.clone() for k, v in state.items()})
    sp.generator = torch.Generator().manual_seed(99)
    losses = [float(sp.train_step({"data": d, "labels": lab.to(torch.int32)}))
              for d, lab in batches]
    params = {k: p.detach() for k, p in sp.model.named_parameters()}
    loss_gap, update_gap = _train_gaps(state, batches, losses, params)
    limit = TRAIN_LIMITS[dtype]
    assert loss_gap <= limit[0] and update_gap <= limit[1]
    c_losses, _, c_params = ref_train.run_steps(
        state, batches, torch.Generator().manual_seed(99), CFG,
        lambda s, x, q, mode: ref.forward(s, x, ARCH, q, mode), "fp8")
    c_loss, c_update = _train_gaps(state, batches, c_losses, c_params)
    assert c_loss > limit[0] or c_update > limit[1]


# GriddedRunner in patch mode over a tiny memmap echogram (the benchmark's
# prediction cell at its tiny size), against the reference stitched over
# the same grid.  Program: prob_gap_max 0.0083-0.0190, _mean
# 0.0013-0.0068 over six seeds, folded and not; fp8 control 0.106-0.173 /
# 0.0210-0.0419.  Each limit lies between them.
PREDICT_LIMITS = {"prob_gap_max": 0.06, "prob_gap_mean": 0.016,
                  "mask_errors": 0, "output_errors": 0,
                  "pixels_compared": 10 ** 12}


@pytest.mark.parametrize("fold", [True, False])
def test_runner_patch_mode_against_the_reference(tmp_path, monkeypatch,
                                                 fold):
    from crimac_unet_tpu_torch.data import blosc_codec
    monkeypatch.setattr(bench_run, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(blosc_codec, "_chunkio", False)
    monkeypatch.setattr(blosc_codec, "_libblosc", False)
    cell = "predict_memm.baseline"
    res = bench_run.run_cell(
        bench_run.load_bench(), cell, 11, 0.5, 0, device="cpu",
        control=True,
        overrides={"config": dict(TINY_CONFIG, **TINY, fold_bn=fold),
                   "workload": dict(tiny_workload(cell),
                                    limits=PREDICT_LIMITS)})
    assert res["correct"], res["checks"]
    assert res["checks"]["pixels_compared"]["value"] > 20000
    assert not res["control_correct"], res["control_checks"]


def test_slab_mode_is_refused():
    model = build_model(CFG)
    with pytest.raises(ValueError, match="infer_mode='slab'.*SegFormer"):
        GriddedRunner(model, _state(0), dict(CFG, infer_mode="slab"),
                      device="cpu")
    runner = GriddedRunner(build_model(CFG), _state(0), CFG, device="cpu")
    assert runner.alignment == 8 and runner.slab_halo is None


def test_folded_decode_head_against_unfolded():
    state = _state(3)
    x = _db(torch.Generator().manual_seed(3))
    ref.calibrate_bn(state, x, ARCH)
    model = build_model(dict(CFG, compute_dtype="float32"))
    model.load_state_dict(state)
    folded, fsd = fold_for_serving(model, state, {"fold_bn": True})
    folded.load_state_dict(fsd)
    assert not folded.use_bn and "decode_head.linear_fuse.bias" in fsd
    assert not any(k.startswith("decode_head.batch_norm") for k in fsd)
    got = folded.eval()(x.permute(0, 2, 3, 1))
    want = model.eval()(x.permute(0, 2, 3, 1))
    # float32 either way: only the order of the affine's products moves
    assert _gap(got, want) <= 1e-5


def test_checkpoint_through_resume_and_the_prediction_entry(tmp_path,
                                                            monkeypatch):
    """A trained SegFormer's ``.pt`` TrainState: read back by resume
    (weights, momentum, step) and served by the save_predict CLI."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.models.weights import load_checkpoint
    from crimac_unet_tpu_torch.pipeline import save_predict
    g = torch.Generator().manual_seed(5)
    sp = SegPipeUNet(CFG)
    sp.init_model(seed=5)
    sp.generator = torch.Generator().manual_seed(1)
    for d, lab in _batches(g, n=2):
        sp.train_step({"data": d, "labels": lab.to(torch.int32)})
    path = tmp_path / "best.pt"
    engine.save_checkpoint(path, sp.state, extras={"best_f1": 0.5})
    sd = load_checkpoint(path)
    assert set(sd) == set(sp.model.state_dict())
    for k, v in sp.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = SegPipeUNet(CFG)
    back.resume_from(path)
    assert back.state.step == 2 and back.best_F1_val == 0.5
    for name, p in back.model.named_parameters():
        buf = back.state.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(buf, engine.momentum_buffers(sp.state)[name])
    with pytest.raises(ValueError, match="TRAINING resume"):
        SegPipeUNet(CFG).resume_from(tmp_path / "weights_only.pt")

    monkeypatch.chdir(tmp_path)
    make_survey_dir("memm", year=2017, n_echograms=1, H=120, W=300, seed=2)
    (tmp_path / "setpyenv.json").write_text(
        json.dumps({"path_to_echograms": "memm"}))
    cfg = dict(CFG, data_mode="memm", partition_predict="selected surveys",
               save_prediction_surveys=[2017], preload_n_pings=150)
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    os.makedirs(tmp_path / "preds")
    save_predict.main(["--yaml_path", "cfg.yaml", "--checkpoint_path",
                       str(path), "--save_predictions_path", "preds"])
    (out,) = sorted((tmp_path / "preds").iterdir())
    pred = np.load(out)
    assert pred.shape[-2:] == (120, 300) and np.isfinite(pred).all()
    assert 0.0 <= pred.min() and pred.max() <= 1.0


@pytest.mark.parametrize("extra", [
    {"meta_channels": META_CHANNELS_ALL},
    {"late_meta_inject": True}])
def test_meta_channels_refused(extra):
    with pytest.raises(ValueError, match="SegFormer takes the acoustic"):
        build_model(dict(CFG, **extra))


def test_export_refuses_segformer(tmp_path):
    from crimac_unet_tpu_torch.pipeline import export
    with pytest.raises(ValueError, match="U-Net only.*'segformer'"):
        export.export_checkpoint(tmp_path / "x.pt", CFG, tmp_path / "a.pt2",
                                 device="cpu")
    with pytest.raises(ValueError, match="U-Net only, not a SegFormer"):
        export.make_serving_forward(build_model(CFG), _state(0), CFG,
                                    device="cpu")


def test_published_widths():
    """MiT-B2 with its decode head at 4 inputs and 3 classes: 27 352 067
    parameters.  At the paper's 3 inputs and 150 classes the same count
    gives 27 461 974 (less the 4th channel's 3 136 patch-embedding
    weights, plus 147 classes' 113 043 classifier weights and biases),
    which the paper states as 27.5M."""
    model = build_model({"architecture": "segformer"})
    assert count_params(model) == 27_352_067
    enc = model.segformer.encoder
    assert [len(b) for b in enc.block] == [3, 4, 6, 3]
    assert [b[0].attention.self.heads for b in enc.block] == [1, 2, 5, 8]
    assert [b[0].attention.self.sr_ratio for b in enc.block] == [8, 4, 2, 1]
    assert model.decode_head.linear_fuse.weight.shape == (768, 3072, 1, 1)
    assert model.alignment == 32 and model.halo is None
    assert abs(enc.block[3][2].drop_path - 0.1) < 1e-7
    assert model.segformer.encoder.layer_norm[0].eps == 1e-6


def test_drop_path_and_dropout_come_from_the_generator():
    """At rate 0 the train step's generator is not drawn from; at the
    published rates the masks are the generator's: the same seed gives
    the same output, another seed another; under a mesh a rank's masks are
    its rows of the global batch's."""
    x = _db(torch.Generator().manual_seed(4)).permute(0, 2, 3, 1)
    state = _state(4)

    def train_out(cfg, seed):
        model = build_model(dict(cfg, compute_dtype="float32"))
        model.load_state_dict(state)
        gen = torch.Generator().manual_seed(seed)
        out = model.train()(x, gen=gen)
        return out.detach(), gen.get_state()

    base = torch.Generator().manual_seed(7).get_state()
    out0, st = train_out(CFG, 7)
    assert torch.equal(st, base)
    live = dict(CFG, drop_path_rate=0.5, classifier_dropout_prob=0.1)
    a, st = train_out(live, 7)
    b, _ = train_out(live, 7)
    c, _ = train_out(live, 8)
    assert not torch.equal(st, base)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, out0)
    whole = Draws(torch.Generator().manual_seed(3))._keep((8, 5), 0.5, "cpu")
    part = Draws(torch.Generator().manual_seed(3), (1, 2))._keep((4, 5), 0.5,
                                                                 "cpu")
    assert torch.equal(part, whole[4:])


def test_profiler_ranges_and_the_pair_counter():
    """The model's ``record_function`` ranges name its blocks in a
    profiler trace, and ``attn_pairs`` counts B * heads * N_q * N_kv a
    call: stage 1 (16 x 16 queries, 8 x 8 keys, one head) and stage 2
    (8 x 8 both, two heads) at batch 2."""
    from torch.profiler import ProfilerActivity, profile
    model = build_model(CFG).eval()
    model.take_attn_pairs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_db(torch.Generator().manual_seed(1), B=2).permute(0, 2, 3, 1))
    names = {e.key for e in prof.key_averages()}
    assert {"segformer.patch_embed", "segformer.attention",
            "segformer.mix_ffn", "segformer.decode_head"} <= names
    assert model.take_attn_pairs() == 2 * (256 * 64 + 2 * 64 * 64)
    assert model.take_attn_pairs() == 0


def test_build_model_builds_the_unet_as_build_unet():
    """Without ``architecture`` (and with ``unet``) the U-Net of
    ``build_unet``: the same state-dict keys and, from the same seeded
    weights, the same output; the runner's alignment and halo of the
    depth-5 U-Net stay 16 and 96."""
    cfg = {"depth": 2, "start_filts": 4, "compute_dtype": "float32"}
    x = _db(torch.Generator().manual_seed(0), B=2, H=32,
            W=32).permute(0, 2, 3, 1)
    want = unet_random_(build_unet(cfg), torch.Generator().manual_seed(0))
    for c in (cfg, dict(cfg, architecture="unet"),
              dict(cfg, architecture="unet_copy")):
        got = unet_random_(build_model(c), torch.Generator().manual_seed(0))
        assert type(got) is type(want)
        assert list(got.state_dict()) == list(want.state_dict())
        assert torch.equal(got.eval()(x), want.eval()(x))
    flagship = {"patch_size": [256, 256], "patch_overlap": 20,
                "frequencies": [18, 38, 120, 200], "infer_mode": "slab",
                "alignment_warning": False}
    model = build_model(flagship)
    runner = GriddedRunner(model, model.state_dict(), flagship, device="cpu")
    assert (runner.alignment, runner.slab_halo) == (16, 96)
    assert not isinstance(model, SegFormer)
    for name in ("vit", "segformr", "unetcopy"):
        with pytest.raises(ValueError, match="architecture must be one of"):
            build_model({"architecture": name})


def test_segformer_b2_preset_builds_the_benchmark_configuration():
    """``config_segformer_b2.yaml`` is the benchmark's configuration
    but for the two regularisers the benchmark sets to 0, and builds
    MiT-B2."""
    yaml = pytest.importorskip("yaml")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "crimac_unet_tpu_torch", "configs",
                           "config_segformer_b2.yaml")) as f:
        preset = yaml.safe_load(f)
    with open(os.path.join(root, "benchmark", "configs",
                           "segformer_b2.json")) as f:
        bench = json.load(f)
    for k, v in preset.items():
        if k in ("drop_path_rate", "classifier_dropout_prob"):
            assert (v, bench[k]) == (0.1, 0.0)
        else:
            assert bench[k] == v, k
    # the benchmark's step is one CUDA graph, which takes both rates at 0
    assert bench["train_graph"] is True and "train_graph" not in preset
    model = build_model(preset)
    assert isinstance(model, SegFormer) and model.dtype == torch.bfloat16
    assert count_params(model) == 27_352_067


def _steps(cfg, state, batches):
    """Three train steps of a ``SegPipeUNet`` on ``cfg`` from ``state``:
    the losses and the parameters after."""
    sp = SegPipeUNet(cfg)
    sp.init_model(state_dict={k: v.clone() for k, v in state.items()})
    sp.generator = torch.Generator().manual_seed(99)
    losses = [float(sp.train_step({"data": d, "labels": lab.to(torch.int32)}))
              for d, lab in batches]
    return losses, {k: p.detach() for k, p in sp.model.named_parameters()}


def test_train_graph_steps_eagerly_off_the_card():
    """``train_graph`` on the CPU runs the same step eagerly (a CUDA graph
    is the card's): the same bits as without it."""
    g = torch.Generator().manual_seed(3)
    state = ref.init_state(g, "cpu", ARCH)
    batches = _batches(g)
    losses, params = _steps(CFG, state, batches)
    g_losses, g_params = _steps(dict(CFG, train_graph=True), state, batches)
    assert g_losses == losses
    assert all(torch.equal(g_params[k], params[k]) for k in params)


@pytest.mark.parametrize("rate", ["drop_path_rate",
                                  "classifier_dropout_prob"])
def test_train_graph_refuses_a_model_that_draws_masks(rate):
    """A graph replays its capture's masks: a model with a drop-path or
    dropout rate above 0 is refused at its first step."""
    cfg = dict(CFG, train_graph=True, **{rate: 0.1})
    g = torch.Generator().manual_seed(4)
    state = ref.init_state(g, "cpu", ref.arch_of(cfg))
    assert build_model(cfg).stochastic and not build_model(CFG).stochastic
    with pytest.raises(ValueError, match="draws no masks"):
        _steps(cfg, state, _batches(g, n=1))


@pytest.mark.parametrize("extra", [{"meta_channels": META_CHANNELS_ALL},
                                   {"late_meta_inject": True,
                                    "meta_channels": META_CHANNELS_ALL}])
def test_train_graph_refuses_metadata_channels(extra):
    with pytest.raises(ValueError, match="single-device"):
        engine.make_train_step(dict(CFG, train_graph=True, **extra))


def test_train_graph_refuses_a_mesh():
    with pytest.raises(ValueError, match="single-device"):
        engine.make_train_step(dict(CFG, train_graph=True), mesh=object())
