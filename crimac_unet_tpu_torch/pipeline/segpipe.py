"""Host-side outputs of an evaluation: the metrics CSV and the PR plot.

The two helpers of the JAX package's ``crimac_unet_tpu/pipeline/
segpipe.py`` that evaluation uses; the rest of that module (the training
loop) comes with the training slice.  Neither pandas nor matplotlib is
needed to write the CSV.
"""

from __future__ import annotations

import csv
import math

import numpy as np

_CSV_COLUMNS = ("precision", "recall", "thresholds", "F1")


def save_metrics_dict(curve: dict, save_path) -> None:
    """CSV with the reference column layout (pipeline.py:358-364 /
    evaluate.py:19-24) as ``pd.DataFrame(curve).to_csv`` writes it: an
    unnamed index column, then precision, recall, thresholds and F1, with
    a trailing NaN threshold (an empty field) for the appended end
    point."""
    cols = {k: np.asarray(curve[k], np.float64) for k in _CSV_COLUMNS}
    cols["thresholds"] = np.append(cols["thresholds"], np.nan)
    n = len(cols["precision"])
    if any(len(v) != n for v in cols.values()):
        raise ValueError("curve columns differ in length: "
                         f"{ {k: len(v) for k, v in cols.items()} }")
    with open(save_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(("",) + _CSV_COLUMNS)
        for i in range(n):
            w.writerow([i] + ["" if math.isnan(cols[k][i]) else
                              repr(float(cols[k][i])) for k in _CSV_COLUMNS])


def save_pr_plot(curve: dict, save_path) -> None:
    """PR scatter PNG (reference evaluate.py:27-36); needs matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("save_pr_plot needs the matplotlib package (the "
                          "metrics CSV does not)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.tick_params(labelsize=6)
    ax.set_xlabel("Recall", fontsize=8)
    ax.set_ylabel("Precision", fontsize=8)
    ax.set_xticks([0, 0.2, 0.4, 0.6, 0.8, 1.0])
    ax.scatter(curve["recall"], curve["precision"], s=2)
    ax.set_xlim(-0.06, 1.06)
    ax.set_ylim(-0.06, 1.06)
    plt.savefig(save_path)
    plt.close(fig)
