"""The port's probes (``scripts/torch_pool_probe.py``, ``torch_pool_v2.py``,
``torch_l0_probe.py``, ``torch_dldw_probe.py``, ``torch_int8_probe.py``,
``torch_h2d_probe.py``) and the pool probe's kernels' plain versions
(``crimac_unet_tpu_torch/ops/pool_probe.py``) against the JAX repo's
scripts.

Small sizes on the CPU, inputs from numpy seeds.  The JAX scripts are
imported from ``scripts/``; ``pallas_pool_probe.py``'s Pallas kernels run
in interpret mode (``pl.pallas_call`` patched with ``interpret=True``).
Tolerances: pools, the space-to-depth kernel and the int8 conv equal bit
for bit (NaN and +-Inf positions included); convs, transposed convs and
weight gradients at float32 within 1e-5 of the largest reference value;
the h2d chunk set equal key for key in shape and dtype.
"""

import functools
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import dldw_probe as jax_dldw  # noqa: E402
import int8_probe as jax_int8  # noqa: E402
import l0_probe as jax_l0  # noqa: E402
import pallas_pool_probe as jax_pool_probe  # noqa: E402

from crimac_unet_tpu_torch.ops import pool_probe  # noqa: E402
from crimac_unet_tpu_torch.ops.pool import maxpool2x2_reference  # noqa: E402
from scripts import (torch_check_common as common,  # noqa: E402
                     torch_dldw_probe, torch_h2d_probe, torch_int8_probe,
                     torch_l0_probe, torch_pool_probe, torch_pool_v2)

TOL = 1e-5
TOOLS = {
    "pool_probe": (torch_pool_probe, ["--batch", "2", "--size", "32"]),
    "pool_v2": (torch_pool_v2, ["--batch", "2", "--size", "32", "--depth",
                                "2", "--start-filts", "4"]),
    "l0_probe": (torch_l0_probe, ["--batch", "2", "--train-batch", "1",
                                  "--size", "16"]),
    "dldw_probe": (torch_dldw_probe, ["--batch", "1", "--size", "16"]),
    "int8_probe": (torch_int8_probe, ["--batch", "1", "--size", "32"]),
    "h2d_probe": (torch_h2d_probe, ["--reps", "1", "--mm-size", "16"]),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: small ops wait on idle threads' barriers when
    the other test workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_nonfinite(a: np.ndarray) -> np.ndarray:
    a = a.copy()
    flat = a.reshape(-1)
    flat[::97] = np.nan
    flat[3::89] = np.inf
    flat[5::83] = -np.inf
    return a


def _bf16_pair(a: np.ndarray):
    """The same bfloat16 values as a JAX and a torch array."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


def _nhwc_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


# --------------------------------------------------------- P1-P3 (pallas)
PALLAS = {"pool_probe_nhwc": "pool_pallas_nhwc",
          "pool_probe_lane128": "pool_pallas_lane128",
          "pool_probe_packed": "pool_pallas_packed"}


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_probe_plain_versions_match_pallas_interpret(name, monkeypatch):
    """Each plain version (and its wrapper on a CPU tensor) bit-equal to
    its Pallas kernel run in interpret mode and to ``pool_rw``, NaN and
    +-Inf written in, at (2, 64, 64, 64) bfloat16."""
    monkeypatch.setattr(jax_pool_probe.pl, "pallas_call", functools.partial(
        jax_pool_probe.pl.pallas_call, interpret=True))
    rng = np.random.RandomState(5)
    x = _with_nonfinite((rng.randn(2, 64, 64, 64) * .1).astype(np.float32))
    xj, xt = _bf16_pair(x)
    want = _np(getattr(jax_pool_probe, PALLAS[name])(xj))
    assert np.isnan(want).any() and np.isinf(want).any()
    kernel, plain, replaces = pool_probe.VARIANTS[name]
    for got in (plain(xt), kernel(xt)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(jax_pool_probe.pool_rw(xj)), want)
    line = int(replaces.rsplit(":", 1)[1])
    src = (REPO / "scripts/pallas_pool_probe.py").read_text().splitlines()
    assert src[line - 1].startswith(f"def {PALLAS[name]}(")


@pytest.mark.parametrize("shape", [(1, 2, 2, 64), (3, 6, 10, 64),
                                   (2, 4, 8, 128)])
def test_probe_plain_versions_equal_max_pool2d(shape):
    """The port's own check (``probe_kernels_equal``) at odd batch and
    width, and P1 and P3 at C = 128; P2 takes C = 64 only."""
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape)
                         .astype(np.float32)).to(torch.bfloat16)
    if shape[3] == 64:
        checks = torch_pool_probe.probe_kernels_equal(x)
        assert all(r["equal"] and r["max_abs_err"] == 0.0
                   for r in checks.values()), checks
    else:
        want = maxpool2x2_reference(x)
        for fn in (pool_probe.pool_nhwc, pool_probe.pool_packed):
            assert torch.equal(fn(x), want)
        with pytest.raises(ValueError, match="C = 64"):
            pool_probe.pool_lane128(x)


@pytest.mark.parametrize("bad", ["dtype", "odd", "rank", "layout"])
def test_probe_wrappers_reject_bad_input(bad):
    x = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16)
    x = {"dtype": x.float(), "odd": x[:, :7], "rank": x[0],
         "layout": x.permute(0, 2, 1, 3)}[bad]
    for fn in (pool_probe.pool_nhwc, pool_probe.pool_lane128,
               pool_probe.pool_packed):
        with pytest.raises(ValueError):
            fn(x)


def test_max_abs_err_reads_nan_positions():
    a = torch.tensor([1.0, float("nan"), 3.0])
    assert torch_pool_probe.max_abs_err(a, a.clone()) == 0.0
    assert torch_pool_probe.max_abs_err(a, torch.tensor([1.5, float("nan"),
                                                         3.0])) == 0.5
    assert torch_pool_probe.max_abs_err(a, torch.ones(3)) == float("inf")


# ------------------------------------------------------------ level 0
L0_B, L0_S = 2, 16


@pytest.fixture(scope="module")
def l0_inputs():
    draws = torch_l0_probe.hwio_draws(L0_B, L0_S, L0_S, seed=3)
    return draws, torch_l0_probe.port_inputs(draws, "cpu", torch.float32)


def test_hwio_draws_are_the_jax_probes():
    """The draws' order and scales are the JAX probe's (l0_probe.main)."""
    x, w, b, xt, wt, bt = torch_l0_probe.hwio_draws(2, 8, 8, seed=0)
    rng = np.random.RandomState(0)
    for got, want in ((x, rng.randn(2, 8, 8, 64) * .1),
                      (w, rng.randn(3, 3, 64, 64) * .05),
                      (b, rng.randn(64) * .05),
                      (xt, rng.randn(2, 4, 4, 128) * .1),
                      (wt, rng.randn(2, 2, 128, 64) * .05),
                      (bt, rng.randn(64) * .05)):
        np.testing.assert_array_equal(got, want.astype(np.float32))


POOLS = {"F.max_pool2d (prod)": "pool_rw", "reshape+amax": "pool_reshape",
         "4x strided slice max": "pool_strided",
         "K2 maxpool2x2": "pool_rw", "K3 relu_pool_skip (+skip)": "pool_rw"}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_l0_pools_bit_equal_jax(name):
    rng = np.random.RandomState(7)
    x = _with_nonfinite((rng.randn(2, 16, 16, 64) * .1).astype(np.float32))
    xj, xt = _bf16_pair(x)
    xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    fn = {n: f for n, f, _, _ in torch_l0_probe.variants(
        {"x": xt, "w": torch.zeros(64, 64, 3, 3), "b": torch.zeros(64),
         "xt": torch.zeros(1, 128, 2, 2), "wt": torch.zeros(128, 64, 2, 2),
         "bt": torch.zeros(64), "k2": None})["pool"]}[name]
    jfn = getattr(jax_l0, POOLS[name])
    if name.startswith("K3"):
        pooled, skip = fn(xt)
        relu = jnp.maximum(xj, 0)           # lax.max keeps NaN
        np.testing.assert_array_equal(_nhwc_np(pooled), _np(jfn(relu)))
        np.testing.assert_array_equal(_nhwc_np(skip), _np(relu))
    else:
        np.testing.assert_array_equal(_nhwc_np(fn(xt)), _np(jfn(xj)))


def test_s2d_kernel_bit_equal_jax():
    w = (np.random.RandomState(1).randn(3, 3, 8, 16) * .05).astype(
        np.float32)
    want = np.asarray(jax_l0.s2d_kernel(jnp.asarray(w)), np.float32)
    got = torch_l0_probe.s2d_kernel(w)
    assert got.shape == (2, 2, 32, 64)
    np.testing.assert_array_equal(got, want)


CONVS = {"channels_last conv (prod)": "conv_nhwc", "NCHW conv": "conv_nchw",
         "Co zero-pad 64->128": "conv_copad",
         "s2d 2x2 conv (16/9 FLOPs)": "conv_s2d2x2",
         "s2d per-phase GEMMs": "conv_s2d",
         "conv_transpose (prod)": "convT_prod", "s2d one GEMM": "convT_s2d"}


@pytest.mark.parametrize("name", list(CONVS))
def test_l0_convs_match_jax_at_float32(name, l0_inputs):
    (x, w, b, xt, wt, bt), p = l0_inputs
    groups = torch_l0_probe.variants(p)
    fns = {n: f for g in ("conv", "convT") for n, f, _, _ in groups[g]}
    jfn = getattr(jax_l0, CONVS[name])
    if name in ("conv_transpose (prod)", "s2d one GEMM"):
        got = fns[name](p["xt"])
        want = jfn(jnp.asarray(xt), jnp.asarray(wt), jnp.asarray(bt))
    else:
        got = fns[name](p["x"].contiguous() if name == "NCHW conv"
                        else p["x"])
        wj = jax_l0.s2d_kernel(jnp.asarray(w)) \
            if name.startswith("s2d 2x2") else jnp.asarray(w)
        want = jfn(jnp.asarray(x), wj, jnp.asarray(b))
    _rel_close(_nhwc_np(got), np.asarray(want))


def test_l0_check_slice_holds_production():
    """The tool's own pre-timing check passes on bfloat16 inputs."""
    p = torch_l0_probe.port_inputs(torch_l0_probe.hwio_draws(2, 16, 16),
                                   "cpu", torch.bfloat16)
    checks = torch_l0_probe.check_slice(p)
    assert len(checks) == 12 and all(r["ok"] for r in checks.values()), \
        checks


# ------------------------------------------------------------------- dL/dW
DW_SHAPES = torch_dldw_probe.shapes(16)


@pytest.mark.parametrize("form", ["default", "taps"])
@pytest.mark.parametrize("shape", DW_SHAPES, ids=[s[0] for s in DW_SHAPES])
def test_dw_matches_jax_at_float32(shape, form):
    name, H, W, Ci, Co = shape
    x, g, w = torch_dldw_probe.draws(1, H, W, Ci, Co,
                                     np.random.RandomState(9))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    if form == "default":
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y, wl = torch_dldw_probe.recorded_conv(xt, wt)
        got = torch_dldw_probe.dw_default(y, wl, gt).permute(2, 3, 1, 0)
        want = jax_dldw.dw_default(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(g))
    else:
        got = torch_dldw_probe.dw_taps(xt, gt)
        assert got.dtype == torch.float32 and got.shape == (3, 3, Ci, Co)
        want = jax_dldw.dw_taps(jnp.asarray(x), jnp.asarray(g))
    _rel_close(got.detach().numpy(), np.asarray(want))


def test_dw_shapes_are_the_jax_probes():
    assert [s[0] for s in torch_dldw_probe.SHAPES] == [
        "down0.conv1", "down0.conv2", "up3.conv1", "up3.conv2",
        "down1.conv2 (ctrl)"]
    assert torch_dldw_probe.shapes(256) == torch_dldw_probe.SHAPES


# -------------------------------------------------------------------- int8
@pytest.mark.parametrize("shape", torch_int8_probe.SHAPES)
def test_int8_conv_equals_jax_int32_conv(shape):
    H, W, Ci, Co = shape
    H, W = H // 16, W // 16
    rng = np.random.RandomState(H)
    x = rng.randn(2, H, W, Ci).astype(np.float32)
    w = rng.randn(3, 3, Ci, Co).astype(np.float32)
    xi = np.clip(x * 16, -127, 127).astype(np.int8)     # the JAX probe's
    wi = np.clip(w * 16, -127, 127).astype(np.int8)
    np.testing.assert_array_equal(
        torch_int8_probe.quantize(torch.from_numpy(x)).numpy(), xi)
    got = torch_int8_probe.conv_int8(
        torch.from_numpy(xi), torch_int8_probe.int8_weight(
            torch.from_numpy(wi)))
    assert got.dtype == torch.int32
    want = np.asarray(jax_int8.conv(jnp.asarray(xi), jnp.asarray(wi),
                                    jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch_int8_probe.check_exact(torch.from_numpy(xi),
                                        torch.from_numpy(wi), got, n=2)


def test_int8_weight_is_column_major():
    wm = torch_int8_probe.int8_weight(torch.zeros((3, 3, 8, 16),
                                                  dtype=torch.int8))
    assert wm.shape == (72, 16) and wm.stride() == (1, 72)


# --------------------------------------------------------------------- h2d
@pytest.mark.parametrize("meta", [False, True])
def test_h2d_chunk_set_is_what_prepare_ships(meta, tmp_path, monkeypatch):
    """``chunk_set`` at a chunk's geometry equals, key for key in shape and
    dtype, the host arrays ``predict_reader`` passes to ``_to_device`` in a
    small memm run (bfloat16 transfer; with and without the six metadata
    families)."""
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline import predict as P
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    make_survey_dir(tmp_path, year=2017, n_echograms=1, H=120, W=300,
                    seed=11)
    cfg = {"patch_size": [64, 64], "patch_overlap": 8,
           "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
           "start_filts": 4, "compute_dtype": "float32",
           "transfer_dtype": "bfloat16"}
    if meta:
        cfg["meta_channels"] = dict(META_CHANNELS_ALL)
    model = init_random_(build_unet(cfg), torch.Generator().manual_seed(0))
    runner = GriddedRunner(build_unet(cfg), model.state_dict(), cfg,
                           device="cpu")
    geoms, hosts = [], []
    geometry, to_device = P.chunk_geometry, P._to_device
    monkeypatch.setattr(P, "chunk_geometry", lambda *a, **k: geoms.append(
        geometry(*a, **k)) or geoms[-1])
    monkeypatch.setattr(P, "_to_device", lambda r, host, s: hosts.append(
        host) or to_device(r, host, s))
    reader = Echogram(next(tmp_path.iterdir()))
    for _ in P.predict_reader(runner, reader, preload_n_pings=150):
        pass
    assert len(hosts) == len(geoms) == 2
    o, (sh, sw) = runner.overlap, runner.stride
    for g, host in zip(geoms, hosts):
        want = torch_h2d_probe.chunk_set(
            g.R, g.C, (sh, sw), o, transfer_dtype="bfloat16",
            meta_channels=runner.meta_channels if meta else None,
            fwd_batch=8, Hs=g.Hs, nr=g.nr)
        assert list(want) == list(host)
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v)) \
                if isinstance(v, np.ndarray) else v
            u = want[k] if isinstance(want[k], torch.Tensor) \
                else torch.from_numpy(want[k])
            assert (tuple(t.shape), t.dtype) == (tuple(u.shape), u.dtype), k


def test_h2d_chunk_set_at_the_jax_probes_geometry():
    host = torch_h2d_probe.chunk_set()
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in host.items()} == {
        "data_slab": ((1120, 1120, 4), "torch.bfloat16"),
        "lab_bits": ((2, 1080, 135), "uint8"),
        "sb_row": ((1081,), "int64")}
    u8 = torch_h2d_probe.chunk_set(transfer_dtype="uint8")
    assert u8["data_slab"].dtype == torch.uint8
    assert u8["lab_bits"].shape == (3, 1080, 135)


# ----------------------------------------------------------------- pool v2
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pool_v2_off_arm_equals_on_arm(dtype):
    """The OFF arm (relu, then ``F.max_pool2d``) bit-equal to the model's
    own forward (K3's plain version on the CPU), depth 3 / start_filts 8."""
    from scripts.torch_roofline import seeded_state_dict, serving_model
    cfg = {"depth": 3, "start_filts": 8, "compute_dtype": dtype,
           "frequencies": common.FREQS}
    model = serving_model(seeded_state_dict(cfg, seed=2), cfg, "cpu")
    x = torch.from_numpy(torch_pool_v2.db_input(2, 32, 32, seed=1))
    on = model(x)
    off = torch_pool_v2.forward_off(model, x)
    assert on.dtype == off.dtype == torch.float32 and on.shape == (2, 32,
                                                                   32, 3)
    assert torch.equal(on, off)


def test_pool_v2_db_input_is_the_jax_scripts():
    got = torch_pool_v2.db_input(1, 4, 4, seed=0)
    rng = np.random.RandomState(0)
    want = rng.lognormal(-12, 3, (1, 4, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        got, np.clip(10 * np.log10(want + 1e-10), -75, 0).astype(np.float32))


# ---------------------------------------------------------------- the tools
@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_and_prints_its_json(tool, capsys):
    mod, argv = TOOLS[tool]
    mod.main(argv + ["--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu"
    if tool == "pool_probe":
        assert all(r["equal"] for r in res["checks"].values())
        assert {r["name"] for r in res["rows"]} >= set(pool_probe.VARIANTS)
    elif tool == "pool_v2":
        assert res["forward"]["logits_equal"]
        assert res["standalone"]["k2_equal"]
    elif tool == "l0_probe":
        assert [b["batch"] for b in res["batches"]] == [2, 1]
        assert all(len(b["rows"]) == 12 for b in res["batches"])
    elif tool == "dldw_probe":
        assert len(res["rows"]) == 5 and all(r["rel_ok"] for r in
                                             res["rows"])
    elif tool == "int8_probe":
        assert len(res["rows"]) == 4 and all(r["int8_exact"] for r in
                                             res["rows"])
    else:
        assert set(res["chunk"]) == {"default", "meta"}
        assert set(res["during_compute"]) == {"compute_alone_ms", "port",
                                              "plain", "pinned"}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TOOLS[tool][0].run("cuda")
