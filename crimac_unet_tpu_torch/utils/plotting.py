"""Echogram / prediction visualization.

Counterpart of the reference reader ``visualize`` methods
(data_reader.py:117-350 memmap, :895-1009 zarr) and utils/plotting.py:
stacked panels of per-frequency dB echograms, the categorical label mask,
optional prediction maps, and the seabed line.  Headless-safe (Agg).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def db(data, eps=1e-10):
    return 10 * np.log10(data + eps)


def _object_bboxes(reader):
    """[(category, y0, y1, x0, x1)] school boxes in (range, ping) index
    space, from either reader flavor (reference data_reader.py:246-276
    draws these as echogram overlays)."""
    out = []
    try:
        objects = reader.objects  # both flavors expose reference dicts
    except (AttributeError, FileNotFoundError):
        return out  # reader has no object source — draw nothing
    for obj in objects:
        bb = obj["bounding_box"]
        out.append((int(obj.get("fish_type_index", 0)), int(bb[0]),
                    int(bb[1]), int(bb[2]), int(bb[3])))
    return out


def visualize_echogram(reader, frequencies=None, ping_idx=0, n_pings=None,
                       range_idx=0, n_range=None, predictions=None,
                       show_labels=True, show_seabed=True, draw_seabed=None,
                       show_object_bboxes=True, save_path=None):
    """Render one echogram window to a matplotlib figure.

    ``predictions``: optional (2, range, ping) or (range, ping) array of
    probabilities to add as extra panel(s).  ``show_object_bboxes`` overlays
    school bounding boxes (green sandeel / white other, reference
    data_reader.py:246-276) on the label panel.  Returns the figure.
    """
    plt = _plt()
    if draw_seabed is not None:  # legacy alias
        show_seabed = draw_seabed

    is_zarr = reader.data_format == "zarr"
    if frequencies is None:
        frequencies = list(np.asarray(reader.frequencies).astype(int))
    if is_zarr:
        W, H = reader.shape
    else:
        H, W = reader.shape
    if n_pings is None:
        n_pings = W - ping_idx
    if n_range is None:
        n_range = H - range_idx
    n_pings = min(n_pings, W - ping_idx)
    n_range = min(n_range, H - range_idx)

    # gather (freq, range, ping) data; labels only when shown — the
    # label read can trigger full-survey cache generation
    # (labels_heave.dat) or warn on unannotated surveys, all for an
    # array that show_labels=False never uses
    labels = None
    if is_zarr:
        data = reader.get_data_slice(ping_idx, n_pings, range_idx, n_range,
                                     frequencies)
        data = data.swapaxes(1, 2)
        if show_labels:
            labels = reader.get_label_slice(ping_idx, n_pings, range_idx,
                                            n_range)
            labels = np.nan_to_num(labels.T, nan=-1.0)
    else:
        data = np.stack([np.asarray(
            m[range_idx:range_idx + n_range, ping_idx:ping_idx + n_pings])
            for m in reader.data_memmaps(frequencies)])
        if show_labels:
            labels = np.asarray(reader.label_memmap()[
                range_idx:range_idx + n_range, ping_idx:ping_idx + n_pings])

    n_panels = len(frequencies) + int(show_labels)
    preds = None
    if predictions is not None:
        preds = np.asarray(predictions)
        if preds.ndim == 2:
            preds = preds[None]
        # accept a full-echogram map OR an already-windowed one; a
        # mismatched array would silently misregister against the sliced
        # data panels under sharex
        if preds.shape[1:] == (H, W):
            preds = preds[:, range_idx:range_idx + n_range,
                          ping_idx:ping_idx + n_pings]
        elif preds.shape[1:] != (n_range, n_pings):
            raise ValueError(
                f"predictions shape {preds.shape[1:]} matches neither the "
                f"echogram {(H, W)} nor the window {(n_range, n_pings)}")
        n_panels += preds.shape[0]

    fig, axes = plt.subplots(n_panels, 1,
                             figsize=(12, 2.2 * n_panels), sharex=True)
    axes = np.atleast_1d(axes)

    seabed = None
    if show_seabed:
        seabed = np.asarray(reader.get_seabed(ping_idx, n_pings)) - range_idx

    x = np.arange(n_pings)
    for i, f in enumerate(frequencies):
        ax = axes[i]
        ax.imshow(db(np.nan_to_num(data[i], nan=0.0)), aspect="auto",
                  cmap="viridis", vmin=-75, vmax=0)
        ax.set_ylabel(f"{f} kHz", fontsize=8)
        if seabed is not None:
            ax.plot(x, seabed, "r-", linewidth=0.6)

    p = len(frequencies)
    if show_labels:
        ax = axes[p]
        lab = labels.astype(float)
        shown = np.zeros_like(lab)
        shown[lab == 27] = 2.0   # sandeel
        shown[lab == 1] = 1.0    # other
        shown[(lab > 0) & (lab != 27) & (lab != 1)] = 3.0
        ax.imshow(shown, aspect="auto", cmap="inferno", vmin=0, vmax=3)
        ax.set_ylabel("labels", fontsize=8)
        if seabed is not None:
            ax.plot(x, seabed, "r-", linewidth=0.6)
        if show_object_bboxes:
            from matplotlib.patches import Rectangle
            for cat, y0, y1, x0, x1 in _object_bboxes(reader):
                # clip to the rendered window, panel coordinates
                rx0, rx1 = x0 - ping_idx, x1 - ping_idx
                ry0, ry1 = y0 - range_idx, y1 - range_idx
                if rx1 < 0 or rx0 >= n_pings or ry1 < 0 or ry0 >= n_range:
                    continue
                color = "lime" if cat == 27 else "white"
                ax.add_patch(Rectangle(
                    (max(rx0, 0) - 0.5, max(ry0, 0) - 0.5),
                    min(rx1, n_pings - 1) - max(rx0, 0) + 1,
                    min(ry1, n_range - 1) - max(ry0, 0) + 1,
                    fill=False, edgecolor=color, linewidth=0.8))
        p += 1

    if preds is not None:
        names = ["p(sandeel)", "p(other)"]
        for k in range(preds.shape[0]):
            ax = axes[p + k]
            ax.imshow(preds[k], aspect="auto", cmap="magma", vmin=0, vmax=1)
            ax.set_ylabel(names[k] if k < 2 else f"pred{k}", fontsize=8)

    axes[-1].set_xlabel("ping")
    fig.suptitle(getattr(reader, "name", "echogram"), fontsize=10)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def visualize_predictions_vs_labels(reader, pred_store, threshold=0.5,
                                    ping_idx=0, n_pings=None,
                                    save_path=None):
    """Prediction-vs-label comparison panels (the reference's zarr
    ``visualize`` offers prediction overlays next to the annotation,
    data_reader.py:895-1009): main-frequency dB echogram with school
    bboxes, the categorical labels, p(sandeel) from a written
    ``<name>_pred.zarr`` store, and an agreement map (true/false
    positives/negatives at ``threshold``).  Returns the figure."""
    plt = _plt()
    from ..data.zarrlite import ZGroup

    g = ZGroup.open(pred_store)
    ann = g["annotation"]          # (2, ping, range), [sandeel, other]
    n_store = ann.shape[1]
    if n_pings is None:
        n_pings = n_store - ping_idx
    n_pings = min(n_pings, n_store - ping_idx)
    p_sandeel = np.asarray(
        ann[0, ping_idx:ping_idx + n_pings, :]).astype(np.float32).T

    is_zarr = reader.data_format == "zarr"
    f0 = int(np.asarray(reader.frequencies).astype(int)[-1])
    n_range = p_sandeel.shape[0]
    if is_zarr:
        data = reader.get_data_slice(ping_idx, n_pings, 0, n_range,
                                     [f0])[0].T
        labels = np.nan_to_num(
            reader.get_label_slice(ping_idx, n_pings, 0, n_range).T,
            nan=-1.0)
    else:
        data = np.asarray(reader.data_memmaps([f0])[0][
            :n_range, ping_idx:ping_idx + n_pings])
        labels = np.asarray(reader.label_memmap()[
            :n_range, ping_idx:ping_idx + n_pings])

    truth = labels == 27
    pred = p_sandeel >= threshold
    # 0 TN, 1 FP, 2 FN, 3 TP
    agreement = (pred.astype(int) + 2 * truth.astype(int)).astype(float)

    fig, axes = plt.subplots(4, 1, figsize=(12, 9), sharex=True)
    axes[0].imshow(db(np.nan_to_num(data, nan=0.0)), aspect="auto",
                   cmap="viridis", vmin=-75, vmax=0)
    axes[0].set_ylabel(f"{f0} kHz", fontsize=8)
    from matplotlib.patches import Rectangle
    for cat, y0, y1, x0, x1 in _object_bboxes(reader):
        rx0, rx1 = x0 - ping_idx, x1 - ping_idx
        if rx1 < 0 or rx0 >= n_pings or y1 < 0 or y0 >= n_range:
            continue
        axes[0].add_patch(Rectangle(
            (max(rx0, 0) - 0.5, max(y0, 0) - 0.5),
            min(rx1, n_pings - 1) - max(rx0, 0) + 1,
            min(y1, n_range - 1) - max(y0, 0) + 1,
            fill=False, edgecolor="lime" if cat == 27 else "white",
            linewidth=0.8))
    shown = np.zeros_like(labels, dtype=float)
    shown[labels == 27] = 2.0
    shown[labels == 1] = 1.0
    axes[1].imshow(shown, aspect="auto", cmap="inferno", vmin=0, vmax=3)
    axes[1].set_ylabel("labels", fontsize=8)
    axes[2].imshow(p_sandeel, aspect="auto", cmap="magma", vmin=0, vmax=1)
    axes[2].set_ylabel("p(sandeel)", fontsize=8)
    from matplotlib.colors import ListedColormap
    # encoding 0=TN 1=FP 2=FN 3=TP; neutral gray for correct background,
    # orange/red for the two error classes, green for hits
    cmap = ListedColormap(["#d9d9d9", "#ff8c00", "#d62728", "#2ca02c"])
    im = axes[3].imshow(agreement, aspect="auto", cmap=cmap,
                        vmin=-0.5, vmax=3.5)
    axes[3].set_ylabel(f"TN/FP/FN/TP @ {threshold}", fontsize=8)
    axes[3].set_xlabel("ping")
    cb = fig.colorbar(im, ax=axes[3], ticks=[0, 1, 2, 3], fraction=0.02)
    cb.ax.set_yticklabels(["TN", "FP", "FN", "TP"], fontsize=7)
    fig.suptitle(f"{getattr(reader, 'name', 'echogram')} — predictions vs "
                 f"labels", fontsize=10)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def visualize_school_detections(reader, detections, gt_boxes=None,
                                ping_idx=0, n_pings=None, frequency=None,
                                save_path=None):
    """Detection-overlay panel for ``pipeline/school_eval.py`` output:
    the main-frequency dB echogram with ground-truth school boxes (solid
    green) and detected school boxes (dashed red, annotated with their
    score).  ``detections`` is the school_eval detection list (or one
    category's list from ``detect_reader_schools``); ``gt_boxes``
    defaults to the reader's sandeel boxes in prediction space
    (school_eval.sandeel_gt_boxes).  Returns the figure."""
    plt = _plt()
    from matplotlib.patches import Rectangle

    if gt_boxes is None:
        from ..pipeline.school_eval import sandeel_gt_boxes
        gt_boxes = sandeel_gt_boxes(reader)

    is_zarr = reader.data_format == "zarr"
    if frequency is None:
        frequency = int(np.asarray(reader.frequencies).astype(int)[-1])
    if is_zarr:
        W, H = reader.shape
    else:
        H, W = reader.shape
    if n_pings is None:
        n_pings = W - ping_idx
    n_pings = min(n_pings, W - ping_idx)
    if is_zarr:
        data = reader.get_data_slice(ping_idx, n_pings, 0, H,
                                     [frequency])[0].T
    else:
        data = np.asarray(reader.data_memmaps([frequency])[0][
            :, ping_idx:ping_idx + n_pings])

    fig, ax = plt.subplots(1, figsize=(12, 5))
    ax.imshow(db(np.nan_to_num(np.asarray(data, dtype=np.float32),
                               nan=0.0)),
              aspect="auto", cmap="viridis", vmin=-75, vmax=0)

    def _draw(box, **kw):
        y0, y1, x0, x1 = box
        rx0, rx1 = x0 - ping_idx, x1 - ping_idx
        if rx1 < 0 or rx0 >= n_pings or y1 < 0 or y0 >= H:
            return False
        ax.add_patch(Rectangle(
            (max(rx0, 0) - 0.5, max(y0, 0) - 0.5),
            min(rx1, n_pings - 1) - max(rx0, 0) + 1,
            min(y1, H - 1) - max(y0, 0) + 1, fill=False, **kw))
        return True

    for box in gt_boxes:
        _draw(box, edgecolor="lime", linewidth=1.0)
    for det in detections:
        if _draw(det["bounding_box"], edgecolor="red", linewidth=1.0,
                 linestyle="--"):
            y0, _, x0, _ = det["bounding_box"]
            ax.annotate(f"{det['score']:.2f}",
                        (x0 - ping_idx, max(y0 - 2, 0)), color="red",
                        fontsize=6)
    ax.set_xlabel("ping")
    ax.set_ylabel("range")
    ax.set_title(f"{getattr(reader, 'name', 'echogram')} — school "
                 f"detections (red dashed) vs annotations (green), "
                 f"{frequency} kHz", fontsize=10)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig
