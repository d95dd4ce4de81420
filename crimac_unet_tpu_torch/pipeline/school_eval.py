"""School-level detection evaluation (working COCO-style evaluator).

The reference ships ``crimac_unet/utils/coco_eval.py`` — a vendored
torchvision COCO detection evaluator — but it imports a nonexistent
``utils`` module and no entry point references it (SURVEY.md §2
"Vestigial: COCO eval"); pixel PR/F1 is the only quality metric that
actually runs there.  Surveys are *consumed* school-by-school, though, so
this module implements what that dead file intended: detection-style
scoring of whole sandeel schools, as a working entry point.

Protocol (COCO-style, self-contained — no pycocotools):

- **Detections**: 4-connected components of the thresholded per-category
  probability maps — sandeel AND other fish, from one predict pass (the
  same connectivity the ground-truth objects are built with,
  data/mat_to_memmap.py:53 / reference generate_memmap_files.py:128-156),
  each scored by its maximum probability.  Components are built
  *streaming* over predict_reader's chunks with a union-find across
  chunk borders — no dense full-survey probability array is ever
  materialized (a production zarr survey is ~4M pings × ~2600 range
  bins: tens of GB dense).
- **Coordinate space**: detections live in the sv/prediction space, i.e.
  the heave-reverted label space.  Memmap ground truth is therefore
  rebuilt from the heave-reverted label map (``label_numpy(heave=True)``)
  rather than taken from the pickled ``objects`` (which are components of
  the ORIGINAL annotation image, data_reader.py:84-113 — vertically off
  by ``round(heave/Δr)`` px wherever heave is non-zero).  Zarr labels and
  the objects CSV already live in sv space.
- **Annotation granularity**: ground-truth objects are per raw file, so
  zarr survey detections are split at ``raw_file`` boundaries before
  matching (a school touching both sides of a file boundary is annotated
  as two objects).
- **Matching**: per reader and IoU threshold, detections sorted by
  descending score greedily claim the highest-IoU unmatched ground-truth
  box (the COCO matching rule); IoUs come from a ping-interval candidate
  prefilter, never a dense detections×GT matrix.
- **AP**: detections pooled over all readers of a survey, ranked globally
  by score; 101-point interpolated average precision per IoU threshold
  (the COCO definition), plus recall/precision at the operating point.

Boxes are inclusive ``[y0, y1, x0, x1]`` in (range, ping) index space —
the convention of ``Echogram.object_bounding_boxes`` and
``DataReaderZarr.objects`` (reference data_reader.py:84-113,637-697).

``min_area`` (default 1) filters *detections only* — ground truth keeps
every annotated component, so raising it can cap recall below 1 for
single-pixel schools; it exists to suppress speckle from noisy models.

CLI::

    python -m crimac_unet_tpu_torch.pipeline.school_eval --yaml_path ... \
        --checkpoint_path model.pt --save_path_metrics ... \
        --save_path_plot ... [--device cpu]

writes ``<survey>_school_eval.csv`` (one row per category and IoU
threshold + summary rows) and ``<survey>_schools.csv`` (the detection
inventory) per evaluation survey.  With ``school_from_predictions`` set
in the YAML it reads written prediction stores and needs no model and no
device.

The port's copy of the JAX package's jax-free
``crimac_unet_tpu/pipeline/school_eval.py``: the live path streams the
port's ``predict_reader`` (on the card, through its kernels), and the two
CSV writers use the ``csv`` module in pandas' layout (the card's machine
has no pandas): the same header, NaN as an empty field, dicts as JSON,
datetime64 ping times as pandas formats them.
"""

from __future__ import annotations

import csv
import json
import math

import numpy as np

from ..constants import RAW_OTHER, RAW_SANDEEL

# COCO evaluates AP at IoU .5:.95; echogram school boxes are small and
# ragged (single-digit pixel heights are common), where a one-pixel shift
# moves IoU a lot — include a loose 0.25 operating point alongside the
# COCO-standard 0.5/0.75.
DEFAULT_IOU_THRESHOLDS = (0.25, 0.5, 0.75)


# ------------------------------------------------------------- detection
class StreamingDetector:
    """4-connected components of ``prob >= threshold``, streamed in
    ping-contiguous chunks with bounded memory.

    Per chunk: one scipy ``ndimage.label`` + per-component reductions;
    components touching the previous chunk's last ping column are merged
    through a union-find, and everything else is finalized immediately
    (it can never merge again), so live state is O(n_range + components
    per chunk) regardless of survey length — speckly probability maps
    produce tens of thousands of components per chunk, and carrying them
    all to the end measurably leaks ~6 MB/chunk.  ``reset_boundary()`` cuts
    connectivity (used at raw-file boundaries)."""

    def __init__(self, prob_threshold: float = 0.5, min_area: int = 1):
        self.thr = float(prob_threshold)
        self.min_area = int(min_area)
        self._parent = []        # union-find over LIVE component ids
        self._stats = []         # per id: [y0, y1, x0, x1, score, n_px]
        self._final = []         # finished merged stats (min_area passed)
        self._prev_col = None    # live ids in the previous last column
        self._next_x = None      # expected x0 of the next chunk

    def _find(self, i: int) -> int:
        parent = self._parent
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:       # path compression
            parent[i], i = root, parent[i]
        return root

    def _union(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[rb] = ra

    def reset_boundary(self) -> None:
        """Forget the carry column: the next chunk is NOT ping-adjacent
        to the previous one (raw-file boundary / new reader)."""
        self._prev_col = None
        self._next_x = None

    def add_chunk(self, probs: np.ndarray, x0: int) -> None:
        """Add an (n_range, w) probability chunk whose first ping is
        survey column ``x0``.  Chunks must arrive in ascending-x order;
        a gap or overlap vs the previous chunk raises."""
        from scipy import ndimage

        probs = np.asarray(probs)
        if probs.ndim != 2:
            raise ValueError(f"chunk must be 2-D, got {probs.shape}")
        if self._next_x is not None and x0 != self._next_x:
            raise ValueError(
                f"non-contiguous chunk: expected x0={self._next_x}, "
                f"got {x0} (call reset_boundary() across gaps)")
        probs32 = probs.astype(np.float32, copy=False)
        mask = np.isfinite(probs32) & (probs32 >= self.thr)
        labeled, n = ndimage.label(mask)
        base = len(self._parent)
        if n:
            self._parent.extend(range(base, base + n))
            slices = ndimage.find_objects(labeled)
            counts = np.bincount(labeled.ravel(), minlength=n + 1)[1:]
            maxs = ndimage.maximum(probs32, labeled,
                                   np.arange(1, n + 1))
            for i in range(n):
                sl = slices[i]
                self._stats.append([sl[0].start, sl[0].stop - 1,
                                    x0 + sl[1].start,
                                    x0 + sl[1].stop - 1,
                                    float(maxs[i]), int(counts[i])])
            if self._prev_col is not None:
                first = labeled[:, 0]
                join = np.nonzero((self._prev_col >= 0)
                                  & (first > 0))[0]
                for r in join:
                    self._union(int(self._prev_col[r]),
                                base + int(first[r]) - 1)
        last = labeled[:, -1] if n else np.zeros(probs.shape[0],
                                                 np.int32)
        self._prev_col = np.where(last > 0, base + last - 1, -1)
        self._next_x = x0 + probs.shape[1]
        self._compact()

    def _merged_groups(self) -> dict:
        """Root id -> merged [y0, y1, x0, x1, score, n_px] over the live
        component set."""
        merged = {}
        for i, (y0, y1, x0, x1, score, n_px) in enumerate(self._stats):
            root = self._find(i)
            m = merged.get(root)
            if m is None:
                merged[root] = [y0, y1, x0, x1, score, n_px]
            else:
                m[0] = min(m[0], y0)
                m[1] = max(m[1], y1)
                m[2] = min(m[2], x0)
                m[3] = max(m[3], x1)
                m[4] = max(m[4], score)
                m[5] += n_px
        return merged

    def _compact(self) -> None:
        """Finalize every component not reachable from the carry column
        (it can never merge with a future chunk) and renumber the
        survivors — the live set stays one-chunk-sized."""
        if not self._stats:
            return
        merged = self._merged_groups()
        # roots must be resolved BEFORE the parent array is replaced
        prev_roots = []
        carried_roots, carried = [], set()
        if self._prev_col is not None:
            prev_roots = [self._find(int(i)) if i >= 0 else -1
                          for i in self._prev_col]
            for root in prev_roots:
                if root >= 0 and root not in carried:
                    carried.add(root)
                    carried_roots.append(root)
        for root, m in merged.items():
            if root not in carried and m[5] >= self.min_area:
                self._final.append(m)
        remap = {}
        self._stats = []
        for root in carried_roots:
            remap[root] = len(self._stats)
            self._stats.append(merged[root])
        self._parent = list(range(len(self._stats)))
        if self._prev_col is not None:
            self._prev_col = np.array(
                [remap[r] if r >= 0 else -1 for r in prev_roots],
                dtype=np.int64)

    def finalize(self) -> list:
        """Merged detections ``{bounding_box, score, n_pixels}`` (boxes
        inclusive, survey coordinates), ``min_area`` applied to the
        merged pixel counts.  Terminal: drains the live set."""
        for m in self._merged_groups().values():
            if m[5] >= self.min_area:
                self._final.append(m)
        self._stats, self._parent = [], []
        self._prev_col, self._next_x = None, None
        out = [{"bounding_box": [int(y0), int(y1), int(x0), int(x1)],
                "score": float(score), "n_pixels": int(n_px)}
               for y0, y1, x0, x1, score, n_px
               in sorted(self._final, key=lambda m: (m[2], m[0]))]
        self._final = []
        return out


def detect_schools(prob_map: np.ndarray, prob_threshold: float = 0.5,
                   min_area: int = 1) -> list:
    """Connected components of a dense (n_range, n_pings) probability map
    as detection dicts — the one-chunk case of :class:`StreamingDetector`
    (NaNs never fire)."""
    det = StreamingDetector(prob_threshold, min_area)
    det.add_chunk(np.asarray(prob_map), 0)
    return det.finalize()


# --------------------------------------------------- detection post-merge
def merge_detections(detections: list, merge_gap: int = 0) -> list:
    """Consolidate fragmented detections: union-find over detection
    boxes whose gap is at most ``merge_gap`` pixels in BOTH axes (boxes
    expanded by ``merge_gap/2`` each side touching/overlapping merge).
    Merged detection = union bounding box, max score, summed pixels.

    Rationale (the JAX package's post-processing study): the trained
    detector over-fragments sandeel schools — thresholded components
    split one acoustic school into many pieces (2362 detections vs 81 GT
    schools on its held-out fixture).  Gap-merging is chunk-boundary-safe
    (it runs on the finalized inventory, unlike a mask closing which
    would need halo reads across streamed chunks).  ``merge_gap=0`` is
    the identity."""
    if merge_gap <= 0 or len(detections) <= 1:
        return list(detections)
    boxes = np.asarray([d["bounding_box"] for d in detections],
                       np.float64)
    half = merge_gap / 2.0
    ex = boxes + np.asarray([-half, half, -half, half])
    n = len(boxes)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # sweep over ping axis to keep the pair scan near-linear
    order = np.argsort(ex[:, 2])
    for oi in range(n):
        i = order[oi]
        for oj in range(oi + 1, n):
            j = order[oj]
            if ex[j, 2] > ex[i, 3]:
                break
            if (ex[i, 0] <= ex[j, 1] and ex[j, 0] <= ex[i, 1]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    merged = []
    for idxs in groups.values():
        bb = boxes[idxs]
        merged.append({
            "bounding_box": [int(bb[:, 0].min()), int(bb[:, 1].max()),
                             int(bb[:, 2].min()), int(bb[:, 3].max())],
            "score": float(max(detections[i]["score"] for i in idxs)),
            "n_pixels": int(sum(detections[i]["n_pixels"]
                                for i in idxs))})
    return merged


# --------------------------------------------------------------- geometry
def bbox_iou(a, b) -> float:
    """IoU of two inclusive [y0, y1, x0, x1] boxes."""
    return float(bbox_iou_matrix(np.asarray([a]), np.asarray([b]))[0, 0])


def bbox_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) IoU matrix of inclusive [y0, y1, x0, x1] boxes —
    one vectorized computation shared by every IoU threshold (a Python
    per-pair loop at survey scale is D*G*|thresholds| calls)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(b, dtype=np.float64).reshape(-1, 4)
    ih = (np.minimum(a[:, None, 1], b[None, :, 1])
          - np.maximum(a[:, None, 0], b[None, :, 0]) + 1).clip(min=0)
    iw = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 2], b[None, :, 2]) + 1).clip(min=0)
    inter = ih * iw
    area_a = (a[:, 1] - a[:, 0] + 1) * (a[:, 3] - a[:, 2] + 1)
    area_b = (b[:, 1] - b[:, 0] + 1) * (b[:, 3] - b[:, 2] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0)


# --------------------------------------------------------------- matching
def match_detections(detections: list, gt_boxes, iou_threshold: float,
                     iou_matrix: np.ndarray = None):
    """COCO greedy matching for one reader at one IoU threshold.

    Returns ``(scores, tp)`` — detection scores in descending order and a
    parallel bool array marking which matched a ground-truth box.  Each GT
    box is claimed at most once, by the highest-scoring detection whose
    IoU with it clears the threshold (ties on IoU go to the earlier GT,
    like pycocotools).

    IoUs are computed per detection against its ping-overlap GT
    candidates (vectorized row at a time) rather than as one dense
    (D, G) matrix: at survey scale a speckly model can emit 1e5
    detections against 1e4 GT schools, where the dense float64 matrix
    alone is multi-GB.  ``iou_matrix`` (detections ×
    gt, in *input* order) short-circuits that when the caller already
    has one."""
    order = np.argsort([-d["score"] for d in detections], kind="stable")
    scores = np.array([detections[i]["score"] for i in order],
                      dtype=np.float64)
    tp = np.zeros(len(order), dtype=bool)
    if len(gt_boxes) == 0 or len(order) == 0:
        return scores, tp
    gt = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    claimed = np.zeros(len(gt), dtype=bool)
    if iou_matrix is not None:
        for row, di in enumerate(order):
            ious = np.where(claimed, -1.0, iou_matrix[di])
            gi = int(np.argmax(ious))
            if ious[gi] >= iou_threshold:
                claimed[gi] = True
                tp[row] = True
        return scores, tp
    # ping-interval prefilter: IoU > 0 requires x-overlap; GT sorted by
    # startping, candidates are those with x0 <= det.x1, then filtered
    # by x1 >= det.x0 — O(candidates) memory per detection
    by_x0 = np.argsort(gt[:, 2], kind="stable")
    gt_x0_sorted = gt[by_x0, 2]
    for row, di in enumerate(order):
        dy0, dy1, dx0, dx1 = detections[di]["bounding_box"]
        hi = np.searchsorted(gt_x0_sorted, dx1, side="right")
        cand = by_x0[:hi]
        cand = cand[(gt[cand, 3] >= dx0) & ~claimed[cand]]
        if cand.size == 0:
            continue
        ious = bbox_iou_matrix(
            np.array([[dy0, dy1, dx0, dx1]], dtype=np.float64),
            gt[cand])[0]
        gi = int(np.argmax(ious))
        if ious[gi] >= iou_threshold:
            # argmax over the candidate subset keeps the pycocotools
            # tie rule: cand preserves input order among equal IoUs
            # only when by_x0 is stable AND x0s differ — re-resolve ties
            # to the earliest input index explicitly
            best = ious[gi]
            winners = cand[ious == best]
            g = int(winners.min())
            claimed[g] = True
            tp[row] = True
    return scores, tp


def average_precision(scores, tp, n_gt: int) -> float:
    """101-point interpolated AP (the COCO definition) from pooled,
    *globally re-ranked* detection scores and their TP flags.

    NaN when there is no ground truth (COCO skips such categories)."""
    if n_gt <= 0:
        return float("nan")
    scores = np.asarray(scores, dtype=np.float64)
    tp = np.asarray(tp, dtype=bool)
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope (monotone non-increasing from the right), then
    # sample at 101 evenly spaced recall points
    envelope = np.maximum.accumulate(precision[::-1])[::-1]
    ap = 0.0
    for r in np.linspace(0.0, 1.0, 101):
        idx = np.searchsorted(recall, r, side="left")
        ap += envelope[idx] if idx < len(envelope) else 0.0
    return float(ap / 101.0)


def school_metrics(per_reader: list,
                   iou_thresholds=DEFAULT_IOU_THRESHOLDS) -> dict:
    """Pool per-reader ``(detections, gt_boxes)`` pairs into survey-level
    detection metrics.

    Matching runs per reader (boxes from different echograms never
    overlap); ranking for AP is global across readers, exactly like COCO
    pools per-image matches into one category curve."""
    out = {"iou_thresholds": list(iou_thresholds),
           "n_gt": int(sum(len(g) for _, g in per_reader)),
           "n_detections": int(sum(len(d) for d, _ in per_reader))}
    aps, recalls, precisions = [], [], []
    for thr in iou_thresholds:
        all_scores, all_tp = [], []
        for detections, boxes in per_reader:
            # candidate-prefiltered matching: no dense (D, G) matrix
            # (multi-GB at survey scale — see match_detections)
            scores, tp = match_detections(detections, boxes, thr)
            all_scores.append(scores)
            all_tp.append(tp)
        scores = np.concatenate(all_scores) if all_scores else \
            np.zeros(0)
        tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
        n_tp = int(tp.sum())
        aps.append(average_precision(scores, tp, out["n_gt"]))
        recalls.append(n_tp / out["n_gt"] if out["n_gt"] else float("nan"))
        precisions.append(n_tp / len(tp) if len(tp) else float("nan"))
    out["ap"] = aps
    out["recall"] = recalls
    out["precision"] = precisions
    finite = [a for a in aps if np.isfinite(a)]
    out["mean_ap"] = float(np.mean(finite)) if finite else float("nan")
    return out


# ------------------------------------------------------------ survey glue
# category name -> (raw on-disk species code, predict_reader channel):
# predictions carry [sandeel, other] probability planes
# (save_predict.py:41-65 fills out[0]=class 1, out[1]=class 2)
CATEGORY_CHANNELS = {"sandeel": (RAW_SANDEEL, 0), "other": (RAW_OTHER, 1)}


def gt_boxes_by_category(reader, raw_categories) -> dict:
    """``{raw species code: [inclusive boxes]}`` for one reader, in the
    *prediction* (sv / heave-reverted) coordinate space — ONE labeling
    pass shared by every requested category (the memmap path loads and
    connected-component-labels the full dense label image; doing that
    once per category doubled the dominant GT cost).

    Memmap: rebuilt from the heave-reverted label map rather than the
    pickled ``objects`` — those are components of the ORIGINAL annotation
    image and sit ``round(heave/Δr)`` px above/below the sv data wherever
    heave is non-zero (reference data_reader.py:386-391 vs :84-113).
    Zarr: the objects CSV already lives in sv space."""
    raw_categories = list(raw_categories)
    if getattr(reader, "data_format", "memm") == "zarr":
        objs = [{"fish_type_index": o["fish_type_index"],
                 "bounding_box": o["bounding_box"]}
                for o in reader.objects]
    else:
        from ..data.mat_to_memmap import objects_from_label_image
        objs = objects_from_label_image(reader.label_numpy(heave=True))
    return {c: [list(o["bounding_box"]) for o in objs
                if o["fish_type_index"] == c] for c in raw_categories}


def gt_boxes(reader, raw_category: int) -> list:
    """Single-category form of :func:`gt_boxes_by_category`."""
    return gt_boxes_by_category(reader, (raw_category,))[raw_category]


def sandeel_gt_boxes(reader) -> list:
    """Sandeel-school boxes in prediction space (see :func:`gt_boxes`)."""
    return gt_boxes(reader, RAW_SANDEEL)


def _raw_file_cuts(reader) -> np.ndarray:
    """Ping indexes where the survey switches raw files (zarr surveys
    concatenate per-file echograms along the ping axis)."""
    raw = getattr(reader, "raw_file", None) if reader is not None else None
    if raw is None or len(raw) < 2:
        return np.zeros(0, dtype=np.int64)
    raw = np.asarray(raw)
    return np.nonzero(raw[1:] != raw[:-1])[0] + 1


def _stream_cut_chunk(det: StreamingDetector, chunk: np.ndarray,
                      start: int, end: int, cuts: np.ndarray) -> None:
    """Feed one (n_range, end-start) chunk, resetting connectivity at
    every raw-file cut inside it — including a cut that lands exactly on
    the chunk's first ping, where the carry column from the previous
    chunk must not union across the file boundary (an interior-only
    filter would merge schools whenever a boundary coincided with a chunk
    edge, e.g. raw files at multiples of the 1000-ping chunk width)."""
    if np.any(cuts == start):
        det.reset_boundary()
    s0 = start
    for cut in cuts[(cuts > start) & (cuts < end)]:
        det.add_chunk(chunk[:, s0 - start:cut - start], s0)
        det.reset_boundary()
        s0 = int(cut)
    det.add_chunk(chunk[:, s0 - start:], s0)


def detect_store_schools(store_path, reader=None, prob_threshold=0.5,
                         min_area=1, channels=(0, 1),
                         chunk_pings=1000) -> dict:
    """Detections from an ALREADY-WRITTEN prediction output — the zarr
    store ``save_survey_predictions_zarr`` produces (``annotation``
    (2, ping_time, range) float16) or the ``.npy`` file of the memm
    variant ((2, n_range, n_pings)) — no model, device, or re-predict
    needed.  The stored values ARE the live predict chunks, so this
    matches ``detect_reader_schools`` exactly.  ``reader`` (optional) supplies the
    raw-file boundaries for the per-file connectivity cut."""
    cuts = _raw_file_cuts(reader)
    if str(store_path).endswith(".npy"):
        arr = np.load(store_path, mmap_mode="r")      # (2, range, ping)
        n_pings = arr.shape[2]

        def get(ch, s, e):
            return np.asarray(arr[ch, :, s:e])
    else:
        from ..data.zarrlite import ZGroup
        ann = ZGroup.open(store_path)["annotation"]   # (2, ping, range)
        n_pings = ann.shape[1]

        def get(ch, s, e):
            return np.asarray(ann[ch, s:e, :]).T
    dets = {ch: StreamingDetector(prob_threshold, min_area)
            for ch in channels}
    for s in range(0, n_pings, chunk_pings):
        e = min(s + chunk_pings, n_pings)
        for ch, det in dets.items():
            _stream_cut_chunk(det, get(ch, s, e), s, e, cuts)
    return {ch: det.finalize() for ch, det in dets.items()}


def detect_reader_schools(runner, reader, preload_n_pings=1000,
                          prob_threshold=0.5, min_area=1,
                          fixed_R=None, fixed_C=None,
                          progress=False, channels=(0, 1)) -> dict:
    """Stream one reader's probability chunks through one
    :class:`StreamingDetector` per requested channel (0 = sandeel,
    1 = other fish; pixels outside the write mask are 0, like the
    reference's out array, save_predict.py:41-65).  Both categories cost
    ONE predict pass.  Returns ``{channel: detections}``.

    Zarr surveys concatenate raw files along the ping axis; connectivity
    is cut at ``raw_file`` boundaries so detections match the per-file
    granularity of the ground-truth objects."""
    from .predict import predict_reader

    cuts = _raw_file_cuts(reader)
    dets = {ch: StreamingDetector(prob_threshold, min_area)
            for ch in channels}
    for start, end, pred, _ in predict_reader(runner, reader,
                                              preload_n_pings,
                                              progress=progress,
                                              fixed_R=fixed_R,
                                              fixed_C=fixed_C):
        pred = np.asarray(pred)
        for ch, det in dets.items():
            _stream_cut_chunk(det, pred[ch], start, end, cuts)
    return {ch: det.finalize() for ch, det in dets.items()}


def _detector_min_area(min_area, category_names=()) -> int:
    """Component-level area filter for the streaming detectors: the
    minimum over per-category values (per-category filtering happens
    afterwards on the finalized lists).  A dict that does not cover
    every evaluated category floors at the uncovered categories'
    default of 1 — otherwise their sub-threshold detections would be
    pre-filtered away."""
    if isinstance(min_area, dict):
        vals = [int(min_area.get(name, 1)) for name in category_names] \
            or [int(v) for v in min_area.values()] or [1]
        return min(vals)
    return int(min_area)


def school_eval_survey(runner, readers, preload_n_pings=1000,
                       prob_threshold=0.5, min_area=1,
                       iou_thresholds=DEFAULT_IOU_THRESHOLDS,
                       save_path_metrics=None, save_path_detections=None,
                       progress=False, categories=None,
                       from_predictions=None, merge_gap=0) -> dict:
    """Survey-level school detection metrics over all its readers, per
    category (sandeel + other fish by default) from ONE predict pass —
    COCO form: per-category AP averaged into the survey mAP.

    ``from_predictions``: a directory of already-written prediction
    outputs (``<reader>_pred.zarr`` / ``<reader>_pred.npy`` as produced
    by save_predict) — detections are read from the stores instead of
    re-running the model; ``runner`` may then be ``None``.

    ``save_path_detections`` additionally writes the detection inventory
    itself (one row per detected school: reader, category, inclusive box,
    score, pixel count) — the per-school product downstream consumers
    want from a survey run, independent of the metric."""
    import os

    if categories is None:
        categories = dict(CATEGORY_CHANNELS)
    readers = list(readers)
    # static_grid on multi-reader surveys: one grid shape for the whole
    # survey, as run_save_predictions runs it
    fixed_R = fixed_C = None
    if from_predictions is None:
        from .predict import survey_static_grid
        fixed_R, fixed_C = survey_static_grid(runner, readers,
                                              preload_n_pings)
    channels = tuple(ch for _, ch in categories.values())
    per_cat = {name: [] for name in categories}
    inventory = []      # (reader_name, category_name, detections)
    for reader in readers:
        if from_predictions is not None:
            rname = getattr(reader, "name", "")
            store = os.path.join(str(from_predictions),
                                 rname + "_pred.zarr")
            if not os.path.isdir(store):
                npy = os.path.join(str(from_predictions),
                                   rname + "_pred.npy")
                if not os.path.isfile(npy):
                    raise FileNotFoundError(
                        f"no prediction output for {rname} under "
                        f"{from_predictions} (looked for "
                        f"{rname}_pred.zarr / {rname}_pred.npy)")
                store = npy
            dets_by_ch = detect_store_schools(
                store, reader, prob_threshold,
                _detector_min_area(min_area, categories), channels=channels,
                # the live path's preload rule (predict_reader):
                # non-positive means 'use the 5000-ping default'
                chunk_pings=preload_n_pings if preload_n_pings > 0
                else 5000)
        else:
            dets_by_ch = detect_reader_schools(
                runner, reader, preload_n_pings, prob_threshold,
                _detector_min_area(min_area, categories), fixed_R=fixed_R,
                fixed_C=fixed_C, progress=progress, channels=channels)
        gts = gt_boxes_by_category(
            reader, [raw for raw, _ in categories.values()])
        for name, (raw_code, ch) in categories.items():
            dets = dets_by_ch[ch]
            # per-category post-processing: min_area/merge_gap may be
            # ints or
            # {category: int} dicts — the measured optima DIFFER by
            # category (gap-merging consolidates fragmented sandeel
            # schools but falsely merges distinct 'other' schools)
            area_c = (min_area.get(name, 1)
                      if isinstance(min_area, dict) else min_area)
            gap_c = (merge_gap.get(name, 0)
                     if isinstance(merge_gap, dict) else merge_gap)
            if area_c > _detector_min_area(min_area, categories):
                dets = [d for d in dets if d["n_pixels"] >= area_c]
            if gap_c:
                dets = merge_detections(dets, gap_c)
            per_cat[name].append((dets, gts[raw_code]))
            inventory.append((reader, name, dets))
    metrics = {"iou_thresholds": list(iou_thresholds),
               "prob_threshold": prob_threshold,
               "min_area": min_area if isinstance(min_area, dict)
               else int(min_area),
               "merge_gap": merge_gap if isinstance(merge_gap, dict)
               else int(merge_gap), "categories": {}}
    for name in categories:
        metrics["categories"][name] = school_metrics(per_cat[name],
                                                     iou_thresholds)
    cat_maps = [m["mean_ap"] for m in metrics["categories"].values()
                if np.isfinite(m["mean_ap"])]
    metrics["mean_ap"] = float(np.mean(cat_maps)) if cat_maps \
        else float("nan")
    # in a process group every rank detects the same schools; rank 0
    # writes
    from ..parallel.mesh import barrier, is_writer
    if is_writer():
        if save_path_metrics is not None:
            save_school_metrics(metrics, save_path_metrics)
        if save_path_detections is not None:
            save_detections_csv(inventory, save_path_detections)
    barrier()
    return metrics


DETECTION_CSV_COLUMNS = ["reader", "category", "upperdepthindex",
                         "lowerdepthindex", "startpingindex",
                         "endpingindex", "upperdepth", "lowerdepth",
                         "startpingtime", "endpingtime", "score",
                         "n_pixels"]


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and math.isnan(v)


def _datetime_cells(values) -> list:
    """pandas' text of a datetime64 column: the date alone when every
    value is midnight, else ``YYYY-MM-DD HH:MM:SS`` with the fewest of 0,
    3, 6 or 9 fraction digits that show every value; NaT empty."""
    ns = [None if _is_nan(v) or np.isnat(np.datetime64(v, "ns"))
          else int(np.datetime64(v, "ns").astype(np.int64)) for v in values]
    live = [t for t in ns if t is not None]
    if all(t % (86400 * 10 ** 9) == 0 for t in live):
        return ["" if t is None else
                np.datetime_as_string(np.datetime64(t, "ns"), unit="D")
                for t in ns]
    frac = [t % 10 ** 9 for t in live]
    digits = (9 if any(f % 1000 for f in frac) else
              6 if any(f % 10 ** 6 for f in frac) else
              3 if any(frac) else 0)
    out = []
    for t in ns:
        if t is None:
            out.append("")
            continue
        text = np.datetime_as_string(np.datetime64(t, "ns"),
                                     unit="s").replace("T", " ")
        if digits:
            text += "." + f"{t % 10 ** 9:09d}"[:digits]
        out.append(text)
    return out


def _csv_cells(values) -> list:
    """The text pandas' ``to_csv`` writes for one column built from these
    values: its dtype inferred as pandas infers it (ints, or floats when
    any value is a float or NaN — ints then print as ``3.0`` — or
    datetime64, or objects), NaN as an empty field."""
    live = [v for v in values if not _is_nan(v) and v is not None]
    if live and all(isinstance(v, np.datetime64) for v in live):
        return _datetime_cells(values)
    numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in live)
    if numeric and len(live) == len(values) and all(
            isinstance(v, (int, np.integer)) for v in live):
        return [str(int(v)) for v in values]
    if numeric:
        f32 = live and all(isinstance(v, np.float32) for v in live)
        return ["" if _is_nan(v) else
                str(np.float32(v)) if f32 else repr(float(v))
                for v in values]
    return ["" if v is None or _is_nan(v) else str(v) for v in values]


def _write_csv(save_path, columns, rows) -> None:
    """``pd.DataFrame(rows, columns=columns).to_csv(save_path,
    index=False)`` with the ``csv`` module."""
    cells = [_csv_cells([r.get(c, float("nan")) for r in rows])
             for c in columns]
    with open(save_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for i in range(len(rows)):
            w.writerow([col[i] for col in cells])


def save_detections_csv(inventory: list, save_path) -> None:
    """Detection inventory CSV: one row per detected school, in the
    objects-CSV column vocabulary (reference data_reader.py:637-697):
    index-space box (``*depthindex`` / ``*pingindex``) plus the physical
    coordinates consumers actually work in — ``upperdepth/lowerdepth``
    in meters from the reader's range vector and
    ``startpingtime/endpingtime`` from its time vector (datetime64 for
    zarr surveys, MATLAB ordinal floats for memmap echograms, NaN when
    a reader has no coordinate vectors).  ``inventory`` is
    ``[(reader, category_name, detections)]``.  No index column: the
    schema is exactly DETECTION_CSV_COLUMNS."""
    rows = []
    for reader, cname, dets in inventory:
        rv = np.asarray(getattr(reader, "range_vector", np.zeros(0)))
        tv = np.asarray(getattr(reader, "time_vector", np.zeros(0)))

        def at(vec, i):
            return vec[i] if 0 <= i < len(vec) else float("nan")

        for d in dets:
            y0, y1, x0, x1 = d["bounding_box"]
            rows.append({"reader": getattr(reader, "name", ""),
                         "category": cname,
                         "upperdepthindex": y0, "lowerdepthindex": y1,
                         "startpingindex": x0, "endpingindex": x1,
                         "upperdepth": at(rv, y0),
                         "lowerdepth": at(rv, y1),
                         "startpingtime": at(tv, x0),
                         "endpingtime": at(tv, x1),
                         "score": d["score"],
                         "n_pixels": d["n_pixels"]})
    _write_csv(save_path, DETECTION_CSV_COLUMNS, rows)


SCHOOL_METRICS_COLUMNS = ["category", "iou_threshold", "AP", "recall",
                          "precision", "n_gt", "n_detections",
                          "prob_threshold", "min_area", "merge_gap"]


def save_school_metrics(metrics: dict, save_path) -> None:
    """CSV: one row per (category, IoU threshold) + one summary row per
    category (its mean AP over thresholds) + an overall-mAP row (the
    COCO headline form)."""
    nan = float("nan")
    rows = []
    for cname, m in metrics["categories"].items():
        for i, t in enumerate(m["iou_thresholds"]):
            rows.append({"category": cname, "iou_threshold": t,
                         "AP": m["ap"][i], "recall": m["recall"][i],
                         "precision": m["precision"][i],
                         "n_gt": m["n_gt"],
                         "n_detections": m["n_detections"]})
        rows.append({"category": cname, "iou_threshold": nan,
                     "AP": m["mean_ap"], "recall": nan,
                     "precision": nan, "n_gt": m["n_gt"],
                     "n_detections": m["n_detections"]})
    rows.append({"category": "mAP", "iou_threshold": nan,
                 "AP": metrics["mean_ap"], "recall": nan,
                 "precision": nan, "n_gt": nan,
                 "n_detections": nan})

    def _col(v, default):
        v = metrics.get(v, default)
        return json.dumps(v) if isinstance(v, dict) else v

    for r in rows:
        r["prob_threshold"] = metrics.get("prob_threshold", nan)
        r["min_area"] = _col("min_area", nan)
        r["merge_gap"] = _col("merge_gap", 0)
    _write_csv(save_path, SCHOOL_METRICS_COLUMNS, rows)


def main(argv=None):
    from .cli_common import load_eval_context

    # from-predictions mode reads written stores: no checkpoint load, no
    # model build, no device (the CLI still requires --checkpoint_path
    # to exist — the reference eval flag set — but never opens it)
    ctx = load_eval_context(
        "eval", argv,
        need_runner=lambda cfg: not cfg.get("school_from_predictions"))
    config, runner, data_obj = ctx.config, ctx.runner, ctx.data_obj

    # knobs are YAML keys (school_prob_threshold / school_min_area /
    # school_iou_thresholds), not CLI flags: the eval flag set stays the
    # reference's (utils/general.py:38-117)
    prob_thr = float(config.get("school_prob_threshold", 0.5))
    # CLI defaults = the JAX package's measured operating point on its
    # 81/76-school held-out fixture: per-category min_area + gap-merge —
    # sandeel
    # fragments (merge at gap 8 lifts AP@0.25 0.20 -> 0.31), 'other'
    # must NOT merge (distinct schools sit close; merging halves its
    # AP).  Values are ints or {category: int} dicts; the pure
    # component inventory is one YAML line away
    # (school_min_area: 1, school_merge_gap: 0).

    def _knob(key, default):
        v = config.get(key, default)
        return ({k: int(x) for k, x in v.items()}
                if isinstance(v, dict) else int(v))

    min_area = _knob("school_min_area", {"sandeel": 9, "other": 64})
    merge_gap = _knob("school_merge_gap", {"sandeel": 8, "other": 0})
    iou_thrs = tuple(config.get("school_iou_thresholds",
                                DEFAULT_IOU_THRESHOLDS))
    # school_from_predictions: detect from a save_predict output dir
    # instead of re-running the model (no device needed)
    from_preds = config.get("school_from_predictions")

    import os
    for survey in data_obj.get_evaluation_surveys():
        readers = data_obj.get_survey_readers(survey)
        print("Running school detection evaluation for", survey)
        metrics = school_eval_survey(
            runner, readers,
            preload_n_pings=int(config.get("preload_n_pings", 1000)),
            prob_threshold=prob_thr, min_area=min_area,
            iou_thresholds=iou_thrs,
            save_path_metrics=os.path.join(
                ctx.metrics_dir, f"{survey}_school_eval.csv"),
            save_path_detections=os.path.join(
                ctx.metrics_dir, f"{survey}_schools.csv"),
            progress=True, from_predictions=from_preds,
            merge_gap=merge_gap)
        for cname, m in metrics["categories"].items():
            ap_str = ", ".join(f"AP@{t:g}={a:.3f}" for t, a in
                               zip(m["iou_thresholds"], m["ap"]))
            print(f"{survey} [{cname}]: mean AP {m['mean_ap']:.3f} "
                  f"({ap_str}), {m['n_detections']} detections / "
                  f"{m['n_gt']} schools")
        print(f"{survey}: mAP {metrics['mean_ap']:.3f}")


if __name__ == "__main__":
    main()
