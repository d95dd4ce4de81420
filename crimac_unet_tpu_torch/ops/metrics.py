"""Streaming PR-curve metrics via exact float16 histograms.

Same statistic as the JAX package's ``crimac_unet_tpu/ops/metrics.py``:
the scored probabilities are float16-quantized values in [0, 1], i.e. one
of 15361 bit patterns (0x0000..0x3C00, monotone in value), so a two-row
histogram over those patterns is a lossless sufficient statistic and the
PR curve built from it is sklearn's on the same float16 scores.

The histogram update runs on the device, by default as one integer
``index_add_`` (the JAX package's ``scatter`` formulation; integer
atomics make it deterministic; its ``sort`` and ``matmul`` formulations
are there too, bit-equal); the curve is built on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LABEL_IGNORE_VAL, LABEL_SEABED_MASK_VAL, SANDEEL
from .label_ops import set_label_ignore_val

# float16 values in [0, 1]: bit patterns 0 .. 0x3C00 (= 15360)
N_F16_BINS = 15361

# bin index -> float16 value (host-side)
F16_BIN_VALUES = np.arange(N_F16_BINS, dtype=np.uint16).view(np.float16)


def f16_bits(preds: torch.Tensor) -> torch.Tensor:
    """float -> float16 (round to nearest even) -> its uint16 bit pattern
    as int32 (monotone for preds >= 0)."""
    bits = preds.to(torch.float16).view(torch.int16).to(torch.int32)
    return bits & 0xFFFF


def new_histogram(device=None) -> torch.Tensor:
    """(2, N_F16_BINS) int32: row 0 = positives (sandeel), row 1 =
    negatives."""
    return torch.zeros((2, N_F16_BINS), dtype=torch.int32, device=device)


def update_pr_histogram(hist: torch.Tensor, preds: torch.Tensor,
                        labels: torch.Tensor, impl: str | None = None
                        ) -> torch.Tensor:
    """Accumulate a batch of sandeel probabilities + sentinel labels into
    ``hist`` IN PLACE (it is returned too).

    The reference's validation filtering (pipeline.py:305-321, :297-303):
    the sandeel probability is zeroed below the seabed, sentinels collapse
    through ``set_label_ignore_val`` and IGNORE pixels are dropped.  Bit
    patterns beyond N_F16_BINS (a NaN probability, a negative zero) are
    dropped, as the JAX scatter drops out-of-range indices.  ``preds``
    (...,) probabilities; ``labels`` (...,) int sentinel labels.

    ``impl`` picks one of the JAX package's three bit-equal formulations:
    ``scatter`` (the default: one integer ``index_add_``), ``sort`` (bin
    and class packed into one key, sorted, counted between searchsorted
    edges) or ``matmul`` (a two-level histogram as one-hot products with
    float32 accumulation, exact below 2^24 pixels a bin)."""
    preds = torch.where(labels == LABEL_SEABED_MASK_VAL, 0.0,
                        preds.to(torch.float32))
    collapsed = set_label_ignore_val(labels)
    bits = f16_bits(preds).reshape(-1)
    valid = (collapsed != LABEL_IGNORE_VAL).reshape(-1)
    pos = (collapsed == SANDEEL).reshape(-1)
    if impl in (None, "scatter"):
        counted = valid & (bits < N_F16_BINS)
        # row 0 for positives, row 1 for negatives; dropped pixels add 0
        # to their own (clamped) bin, so the update needs no data-dependent
        # shape (no host sync) and their atomics do not all contend on one
        # address
        idx = (bits.clamp(max=N_F16_BINS - 1)
               + (~pos).to(torch.int32) * N_F16_BINS)
        hist.view(-1).index_add_(0, idx, counted.to(hist.dtype))
    elif impl == "sort":
        # invalid pixels -> a key past every real (bin, class) pair; keys
        # of out-of-range bit patterns fall past the last edge too
        key = torch.where(valid, bits * 2 + pos.to(torch.int32),
                          2 * N_F16_BINS)
        edges = torch.searchsorted(
            torch.sort(key).values,
            torch.arange(2 * N_F16_BINS + 1, dtype=key.dtype,
                         device=key.device))
        counts = edges.diff().reshape(N_F16_BINS, 2)
        hist += torch.stack([counts[:, 1], counts[:, 0]]).to(hist.dtype)
    elif impl == "matmul":
        hist += _matmul_histogram(bits, valid & pos,
                                  valid & ~pos).to(hist.dtype)
    else:
        raise ValueError(f"impl must be 'scatter', 'sort' or 'matmul', "
                         f"not {impl!r}")
    return hist


_LO = 128                                  # low digit of the two-level bin
_N_HI = (N_F16_BINS + _LO - 1) // _LO      # 121
_MATMUL_ROWS = 1 << 18                     # pixels per one-hot product


def _matmul_histogram(bits, vpos, vneg) -> torch.Tensor:
    """(2, N_F16_BINS) counts as ``onehot_hi^T @ onehot_lo`` products:
    every product is an exact 0/1 and float32 holds the integer counts
    exactly, so the result equals the scatter's.  Bit patterns past the
    last high digit have an all-zero one-hot row and drop out."""
    dev = bits.device
    hi_range = torch.arange(_N_HI, dtype=torch.int32, device=dev)
    lo_range = torch.arange(_LO, dtype=torch.int32, device=dev)
    acc = torch.zeros((2, _N_HI, _LO), dtype=torch.float32, device=dev)
    for s in range(0, bits.numel(), _MATMUL_ROWS):
        b = bits[s:s + _MATMUL_ROWS]
        oh_hi = (b[:, None] // _LO == hi_range).to(torch.float32)
        oh_lo = (b[:, None] % _LO == lo_range).to(torch.float32)
        for row, mask in enumerate((vpos, vneg)):
            m = mask[s:s + _MATMUL_ROWS].to(torch.float32)[:, None]
            acc[row] += (oh_hi * m).T @ oh_lo
    return acc.reshape(2, -1)[:, :N_F16_BINS].round().to(torch.int32)


def pr_curve_from_histogram(hist: np.ndarray) -> dict:
    """The sklearn-identical PR curve from the histogram (host side):
    ``sklearn.metrics.precision_recall_curve(y_true, probas_pred,
    pos_label=SANDEEL)`` followed by the reference's F1 (pipeline.py:
    284-295) — thresholds ascending over distinct score values, with the
    (precision=1, recall=0) end point appended.  Modern sklearn (>= 1.x);
    the reference's pinned 0.24.1 also truncated the curve at the first
    full-recall threshold, which moves only the CSV/plot tail
    (DIVERGENCES.md)."""
    hist = np.asarray(hist)
    pos, neg = hist[0].astype(np.int64), hist[1].astype(np.int64)
    present = (pos + neg) > 0
    bins = np.nonzero(present)[0]
    thresholds = F16_BIN_VALUES[bins].astype(np.float16)

    # tps/fps at threshold t = counts with score >= t (reverse cumsum)
    tps = np.cumsum(pos[bins][::-1])[::-1]
    fps = np.cumsum(neg[bins][::-1])[::-1]

    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros(len(ps)), where=ps != 0)
    if len(tps) == 0 or tps[0] == 0:  # no positives anywhere
        recall = np.ones(len(tps))
    else:
        recall = tps / tps[0]

    precision = np.concatenate([precision, [1.0]])
    recall = np.concatenate([recall, [0.0]])

    numerator = 2 * recall * precision
    denom = recall + precision
    f1 = np.divide(numerator, denom, out=np.zeros_like(denom),
                   where=denom != 0)
    return {"precision": precision, "recall": recall,
            "thresholds": thresholds.astype(np.float64), "F1": f1}


def max_f1(metrics: dict) -> tuple:
    f1 = metrics["F1"]
    idx = int(np.argmax(f1))
    return float(f1[idx]), idx
