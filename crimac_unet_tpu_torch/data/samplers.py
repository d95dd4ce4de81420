"""Random patch samplers (host side).

The port's copy of ``crimac_unet_tpu/data/samplers.py``: the six-sampler
battery driving class-balanced training (reference batch/samplers/*,
wired in data/partition.py): Background, Seabed, School(sandeel),
School(other), SchoolSeabed(sandeel), SchoolSeabed(other) with mixture
probabilities [1, 5, 5, 5, 5, 5], in a memmap and a zarr form, and the
deterministic ``Gridded`` sampler over the inference grids.  The
draws equal the JAX package's from the same ``RandomState``, draw for
draw.

Each sampler's ``get_sample(rng) -> ([y, x], reader)`` (y = range row,
x = ping column, for both forms).  Rejection loops are iterative with a
retry cap instead of the reference's unbounded recursion
(background.py:60-61; deliberate robustness divergence).

The zarr samplers read the objects table as the reader returns it, a
dict of numpy columns (``DataReaderZarr.get_fish_schools``); a filter
is a boolean mask over its rows.  BackgroundSeabed /
BackgroundSeabedZarr exist in the reference but are wired into no
pipeline (SURVEY.md §2); kept for API completeness.
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils.grids import random_point_containing

_MAX_RETRIES = 200

_LOG = logging.getLogger(__name__)


def _note_give_up(sampler, detail: str) -> None:
    """Record a rejection-sampler give-up (``_MAX_RETRIES`` candidate
    draws all rejected; the fallback sample may violate the sampler's
    label contract, e.g. a Background crop containing fish).  Give-ups
    are rare on real surveys but silent label contamination in training
    deserves a signal: every instance carries a ``give_ups`` counter and
    the first few log a warning."""
    n = getattr(sampler, "give_ups", 0) + 1
    sampler.give_ups = n
    if n <= 3 or n % 1000 == 0:
        _LOG.warning(
            "%s.get_sample gave up after %d rejections (%s); returning "
            "last candidate (give-up #%d on this sampler)",
            type(sampler).__name__, _MAX_RETRIES, detail, n)


def _draw_ping(rng, W: int, ww: int) -> int:
    """Reference ping draw for seabed-anchored samplers
    (seabed.py:32-54): x in [w/2-20, W-w/2+20), clamped into the survey —
    for small windows that raw range leaves it (no-op for reference-size
    windows)."""
    if W <= ww:
        return W // 2
    half = ww // 2 - 20
    return int(np.clip(rng.randint(half, W - half), 0, W - 1))


class Background:
    """Random location above the seabed with zero fish labels in the crop
    (reference background.py:23-63)."""

    def __init__(self, readers, window_size):
        self.readers = list(readers)
        self.window_size = window_size

    def _candidate(self, rng):
        ech = self.readers[rng.randint(len(self.readers))]
        H, W = ech.shape
        wh, ww = self.window_size
        x = _draw_ping(rng, W, ww)
        seabed = int(ech.get_seabed(x, 1)[0])
        if seabed <= wh:
            y = H // 2
        else:
            y = rng.randint(wh // 2, seabed - wh // 2)
        return [y, x], ech

    def get_sample(self, rng):
        for _ in range(_MAX_RETRIES):
            (y, x), ech = self._candidate(rng)
            # reference reads with boundary fill 0 and rejects any nonzero
            # label (background.py:57-61); our crop fills boundary with
            # -100, which labels_any does not count
            if not ech.labels_any([y, x], self.window_size):
                return [y, x], ech
        _note_give_up(self, "every candidate crop contained fish labels")
        return [y, x], ech


class BackgroundZarr:
    """Background sampling restricted to STOX-valid ping ranges
    (reference background.py:66-103)."""

    def __init__(self, readers, window_size=(256, 256)):
        self.readers = list(readers)
        self.window_size = window_size

    def get_sample(self, rng):
        wh, ww = self.window_size
        sample = None
        for _ in range(_MAX_RETRIES):
            z = self.readers[rng.randint(len(self.readers))]
            ranges = z.get_valid_pings()
            start, end = ranges[rng.randint(len(ranges))]
            if end <= start:  # degenerate STOX transect (< one ping)
                end = start + 1
            x = int(rng.randint(start, end))
            seabed = int(z.get_seabed(x, 1)[0])
            y = int(rng.randint(0, max(seabed - wh // 2, 1)))
            # the give-up fallback is a consistent (y, x, reader) triple
            # of one draw
            sample = ([y, x], z)
            if seabed - wh // 2 <= 0:
                continue
            # reference check window (background.py:93-99): offset one
            # left/up of the training crop — kept verbatim for parity
            labels = z.get_label_slice(
                idx_ping=max(0, x - ww // 2), n_pings=ww,
                idx_range=max(0, y - wh // 2), n_range=wh)
            if not np.any(np.nan_to_num(labels, nan=0) > 0):
                return sample
        _note_give_up(self, "every candidate crop contained fish labels "
                            "or sat below the seabed")
        return sample


class Seabed:
    """Random ping, y near the seabed line (reference seabed.py:23-54)."""

    def __init__(self, readers, window_size):
        self.readers = list(readers)
        self.window_size = window_size

    def get_sample(self, rng):
        ech = self.readers[rng.randint(len(self.readers))]
        H, W = ech.shape
        wh, ww = self.window_size
        x = _draw_ping(rng, W, ww)
        seabed = int(ech.get_seabed(x, 1)[0])
        y = random_point_containing(H, wh, seabed, rng=rng)
        return [y, x], ech


class SeabedZarr:
    """(reference seabed.py:57-78)"""

    def __init__(self, readers, window_size=(256, 256)):
        self.readers = list(readers)
        self.window_size = window_size

    def get_sample(self, rng):
        wh, ww = self.window_size
        for _ in range(_MAX_RETRIES):
            z = self.readers[rng.randint(len(self.readers))]
            n_pings = z.shape[0]
            # surveys narrower than the window: center ping (the memmap
            # Seabed sampler's _draw_ping guard; the reference's zarr
            # variant crashes on randint(low >= high), seabed.py:67)
            x = n_pings // 2 if n_pings <= ww else \
                int(rng.randint(ww // 2, n_pings - ww // 2))
            y = int(z.get_seabed(x, 1)[0])
            if y <= 0:
                continue
            y += rng.randint(-(wh // 2), wh // 2 + 1)
            return [y, x], z
        _note_give_up(self, "no positive seabed estimate found")
        return [max(y, 1), x], z  # give-up fallback: last draw, clamped


class School:
    """Uniform over (echogram, school) pairs of a fish type; random labelled
    pixel clamped into a valid window (reference school.py:22-81)."""

    def __init__(self, readers, window_size, fish_type="all"):
        self.window_size = window_size
        self.schools = []
        for e in readers:
            for o in e.objects:
                ft = o["fish_type_index"]
                if (fish_type == "all" or ft == fish_type
                        or (isinstance(fish_type, list) and ft in fish_type)):
                    self.schools.append((e, o))
        if not self.schools:
            raise ValueError(f"fish_type {fish_type} not found in any echogram")

    def get_sample(self, rng):
        ech, obj = self.schools[rng.randint(len(self.schools))]
        y, x = obj["indexes"][rng.randint(obj["n_pixels"])]
        x = random_point_containing(ech.shape[1], self.window_size[1], x,
                                    rng=rng)
        y = random_point_containing(ech.shape[0], self.window_size[0], y,
                                    rng=rng)
        return [int(y), int(x)], ech


_BBOX_COLUMNS = ("startpingindex", "endpingindex", "upperdepthindex",
                 "lowerdepthindex")


class SchoolZarr:
    """Uniform over zarr file -> random school bbox -> random point + jitter
    (reference school.py:84-124)."""

    def __init__(self, readers, window_size, fish_type="all"):
        self.window_size = window_size
        self._collect_schools(readers, fish_type)

    def _collect_schools(self, readers, fish_type, row_filter=None,
                         what="schools"):
        """Populate ``self.schools`` as (reader, bboxes) pairs, dropping
        school-less files up front (the reference draws a random file per
        sample and crashes on an empty one, school.py:99) — the per-sample
        draw stays uniform over the kept files.  ``row_filter`` maps the
        objects table to a boolean row mask (SchoolSeabedZarr's
        seabed-distance cut).  The bboxes take the columns' common
        dtype, as pandas' ``.values`` does."""
        self.schools = []
        readers = list(readers)  # len() below; accept iterators
        n_empty = 0
        for z in readers:
            table = z.get_fish_schools(category=fish_type)
            if row_filter is not None:
                keep = row_filter(table)
                table = {k: v[keep] for k, v in table.items()}
            bboxes = np.stack([table[c] for c in _BBOX_COLUMNS], axis=1)
            if len(bboxes) == 0:
                n_empty += 1
                continue
            self.schools.append((z, bboxes))
        if n_empty:
            _LOG.warning("%s: %d/%d zarr files have no %r %s and "
                         "are excluded from sampling", type(self).__name__,
                         n_empty, len(readers), fish_type, what)
        if not self.schools:
            raise ValueError(f"no {what} of fish_type {fish_type!r} in "
                             "any zarr file")

    def get_sample(self, rng):
        z, bboxes = self.schools[rng.randint(len(self.schools))]
        bbox = bboxes[rng.randint(bboxes.shape[0])].copy()
        if bbox[0] == bbox[1]:
            bbox[1] += 1
        if bbox[2] == bbox[3]:
            bbox[3] += 1
        x = rng.randint(bbox[0], bbox[1])
        y = rng.randint(bbox[2], bbox[3])
        x += rng.randint(-(self.window_size[1] // 2),
                         self.window_size[1] // 2 + 1)
        y += rng.randint(-(self.window_size[0] // 2),
                         self.window_size[0] // 2 + 1)
        return [int(y), int(x)], z


class SchoolSeabed(School):
    """Schools within ``max_dist_to_seabed`` of the seabed line
    (reference school_seabed.py:24-61)."""

    def __init__(self, readers, window_size, max_dist_to_seabed,
                 fish_type="all"):
        super().__init__(readers, window_size, fish_type)
        kept = []
        for ech, obj in self.schools:
            bb = obj["bounding_box"]
            center_ping = int((bb[2] + bb[3]) / 2)
            seabed = ech.get_seabed(0, ech.shape[1])[center_ping]
            if abs(int(seabed) - int(bb[1])) < max_dist_to_seabed:
                kept.append((ech, obj))
        self.schools = kept
        if not self.schools:
            raise ValueError(
                f"no fish_type={fish_type} schools within "
                f"{max_dist_to_seabed}px of the seabed")


class SchoolSeabedZarr(SchoolZarr):
    """(reference school_seabed.py:63-99)"""

    def __init__(self, readers, window_size, max_dist_to_seabed=20,
                 fish_type="all"):
        self.window_size = window_size
        # signed comparison kept verbatim from the reference
        # (school_seabed.py:73; its memm variant uses abs()); a NaN
        # distance compares False, as in pandas
        self._collect_schools(
            readers, fish_type,
            row_filter=lambda t: t["distance_to_seabed"] < max_dist_to_seabed,
            what=f"schools within {max_dist_to_seabed}px of the seabed")


class Gridded:
    """Deterministic sampler over the full inference grids of a reader list
    (reference gridded.py:98-118; that class passed window/overlap into the
    start/end positional slots of get_data_grid — a latent bug in code no
    entry point reaches — fixed here by calling with keywords)."""

    def __init__(self, readers, window_size, patch_overlap=20, mode="all"):
        from ..ops.patches import grid_centers
        self.readers = list(readers)
        self.window_size = window_size
        coords = []
        for i, reader in enumerate(self.readers):
            if reader.data_format == "zarr":
                n_pings, n_range = reader.shape
            else:
                n_range, n_pings = reader.shape
            sb = np.asarray(reader.get_seabed(0, n_pings))
            # pings without a seabed estimate (degraded no-bottom-store
            # surveys) count as full-water-column, like the pipeline grid
            # (the raw zero vector would cap the grid at ~50 rows)
            has = np.asarray(reader.seabed_known(0, n_pings))
            sb = np.where(has, sb, n_range)
            end_range = int(min(sb.max() + 50, n_range))
            ys = grid_centers(0, end_range, window_size[0], patch_overlap)
            xs = grid_centers(0, n_pings, window_size[1], patch_overlap)
            if mode in ("region", "trace"):
                xs_rel, ys_rel = [], []
                if mode == "trace":
                    ys_rel = list(ys)
                for obj in reader.objects:
                    y0, y1, x0, x1 = obj["bounding_box"]
                    xi = sorted({int(np.abs(x0 - xs).argmin()),
                                 int(np.abs(x1 - xs).argmin())})
                    if mode == "region":
                        yi = sorted({int(np.abs(y0 - ys).argmin()),
                                     int(np.abs(y1 - ys).argmin())})
                        for j in yi:
                            for k in xi:
                                ys_rel.append(ys[j])
                                xs_rel.append(xs[k])
                    else:
                        xs_rel.extend(xs[k] for k in xi)
                if mode == "trace":
                    mesh = np.meshgrid(ys_rel, np.unique(xs_rel))
                    pts = np.array(mesh).T.reshape(-1, 2)
                else:
                    pts = np.array([ys_rel, xs_rel]).T if ys_rel else \
                        np.zeros((0, 2))
            else:
                pts = np.array(np.meshgrid(ys, xs)).T.reshape(-1, 2)
            if len(pts):
                coords.append(np.concatenate(
                    [np.full((len(pts), 1), i), pts], axis=1))
        self.coords_list = (np.concatenate(coords, axis=0).astype(int)
                            if coords else np.zeros((0, 3), int))

    def __len__(self):
        return len(self.coords_list)

    def get_sample(self, i):
        ei, y, x = self.coords_list[i]
        return [int(y), int(x)], self.readers[int(ei)]


class BackgroundSeabed(Background):
    """Background-style rejection sampling with the patch forced to contain
    the seabed (reference background_seabed.py:24-62; not wired into any
    pipeline battery)."""

    def _candidate(self, rng):
        ech = self.readers[rng.randint(len(self.readers))]
        H, W = ech.shape
        wh, ww = self.window_size
        x = _draw_ping(rng, W, ww)
        seabed = int(ech.get_seabed(x, 1)[0])
        y = random_point_containing(H, wh, seabed, rng=rng)
        return [y, x], ech


class BackgroundSeabedZarr:
    """Seabed-anchored fish-free crops from STOX-valid ping ranges
    (reference background_seabed.py:64-97; wired into no reference
    pipeline — provided for sampler-battery API completeness).

    The reference rejects via ``np.any(labels != 0)`` — NaN labels count
    as nonzero there (unlike ``BackgroundZarr``'s ``labels > 0``); kept
    verbatim for parity.  Iterative with a retry cap instead of the
    reference's unbounded recursion."""

    def __init__(self, readers, window_size=(256, 256)):
        self.readers = list(readers)
        self.window_size = window_size

    def get_sample(self, rng):
        wh, ww = self.window_size
        sample = None
        for _ in range(_MAX_RETRIES):
            z = self.readers[rng.randint(len(self.readers))]
            ranges = z.get_valid_pings()
            start, end = ranges[rng.randint(len(ranges))]
            if end <= start:  # degenerate STOX transect (< one ping)
                end = start + 1
            x = int(rng.randint(start, end))
            y = int(z.get_seabed(x, 1)[0])
            # seabed not always mid-crop (background_seabed.py:88)
            y += int(rng.randint(-(wh // 2), wh // 2 + 1))
            sample = ([y, x], z)
            # reference check window (background_seabed.py:91-95): columns
            # centered on x but rows starting at y (one half-window below
            # the training crop) — kept verbatim for parity
            labels = z.get_label_slice(
                idx_ping=max(0, x - ww // 2), n_pings=ww,
                idx_range=max(0, y), n_range=wh)
            if not np.any(np.nan_to_num(labels, nan=1) != 0):
                return sample
        _note_give_up(self, "every candidate crop contained nonzero/NaN "
                            "labels")
        return sample
