"""The port's PR histogram and curve against the JAX package.  Stated
tolerance: bit-equal (integer counts of float16 bit patterns; the curve is
the same numpy code on the same counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu_torch.ops import metrics


def _preds_and_labels(seed, n=(6, 32, 40)):
    rng = np.random.RandomState(seed)
    preds = rng.rand(*n).astype(np.float32)
    flat = preds.reshape(-1)
    # exact 0 and 1, float16 rounding edges (halfway between two f16
    # values, one f32 ulp either side), tiny subnormals, NaN (dropped)
    one = np.float16(0.5)
    half_up = (np.float32(one) + np.float32(np.spacing(one)) / 2)
    flat[:14] = [0.0, 1.0, half_up, np.nextafter(half_up, np.float32(0)),
                 np.nextafter(half_up, np.float32(1)), 1e-8, 6e-8, 3e-5,
                 np.nextafter(np.float32(1), np.float32(0)), 0.99951171875,
                 0.999755859375, np.nan, 0.25, -0.0]
    labels = rng.choice([0, 1, 2, -100, -70, -50, -30, -10, -1],
                        size=n).astype(np.int32)
    return preds, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_pr_histogram_matches_jax(seed):
    preds, labels = _preds_and_labels(seed)
    hist = metrics.new_histogram()
    assert hist.dtype == torch.int32 and hist.shape == (2, metrics.N_F16_BINS)
    got = metrics.update_pr_histogram(hist, torch.from_numpy(preds),
                                      torch.from_numpy(labels))
    assert got is hist                          # updated in place
    # accumulate: a second batch adds on top
    p2, l2 = _preds_and_labels(seed + 10)
    metrics.update_pr_histogram(hist, torch.from_numpy(p2),
                                torch.from_numpy(l2))
    for impl in ("scatter", "sort"):
        want = jax_metrics.new_histogram()
        for p, lab in ((preds, labels), (p2, l2)):
            want = jax_metrics.update_pr_histogram(
                want, jnp.asarray(p), jnp.asarray(lab), impl=impl)
        np.testing.assert_array_equal(hist.numpy(), np.asarray(want),
                                      err_msg=impl)
    # the NaN and the negative zero are dropped, not counted anywhere
    # (below the seabed the score is replaced by 0.0 first)
    def n_counted(p, lab):
        valid = ~np.isin(lab, [-100, -70, -30, -10])
        dropped = (np.isnan(p) | ((p == 0) & np.signbit(p))) & (lab != -50)
        return int((valid & ~dropped).sum())
    assert int(hist.sum()) == n_counted(preds, labels) + n_counted(p2, l2)


def test_f16_bits_matches_jax():
    preds, _ = _preds_and_labels(3)
    np.testing.assert_array_equal(
        metrics.f16_bits(torch.from_numpy(preds)).numpy(),
        np.asarray(jax_metrics.f16_bits(jnp.asarray(preds))))


@pytest.mark.parametrize("seed", [4, 5])
def test_pr_curve_and_max_f1_identical(seed):
    preds, labels = _preds_and_labels(seed)
    hist = metrics.update_pr_histogram(
        metrics.new_histogram(), torch.from_numpy(preds),
        torch.from_numpy(labels)).numpy().astype(np.int64)
    got = metrics.pr_curve_from_histogram(hist)
    want = jax_metrics.pr_curve_from_histogram(hist)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert metrics.max_f1(got) == jax_metrics.max_f1(want)
    # no positives at all: recall is 1 at every threshold, as in JAX
    hist[0] = 0
    got, want = (m.pr_curve_from_histogram(hist)
                 for m in (metrics, jax_metrics))
    np.testing.assert_array_equal(got["recall"], want["recall"])
    np.testing.assert_array_equal(metrics.F16_BIN_VALUES,
                                  jax_metrics.F16_BIN_VALUES)
