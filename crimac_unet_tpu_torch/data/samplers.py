"""Random patch samplers of memmap surveys (host side).

The port's copy of the memmap half of ``crimac_unet_tpu/data/samplers.py``:
the six-sampler battery driving class-balanced training (reference
batch/samplers/*, wired in data/partition.py): Background, Seabed,
School(sandeel), School(other), SchoolSeabed(sandeel),
SchoolSeabed(other) with mixture probabilities [1, 5, 5, 5, 5, 5].  The
draws equal the JAX package's from the same ``RandomState``.

Each sampler's ``get_sample(rng) -> ([y, x], reader)`` (y = range row,
x = ping column — memmap orientation).  Rejection loops are iterative with a
retry cap instead of the reference's unbounded recursion
(background.py:60-61; deliberate robustness divergence).

BackgroundSeabed exists in the reference but is wired into no pipeline
(SURVEY.md §2); kept for API completeness.  The zarr samplers come with
zarr training (ROADMAP A1b).
"""

from __future__ import annotations

import logging

import numpy as np

from ..constants import LABEL_BOUNDARY_VAL
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
            labels = ech.crop_labels([y, x], self.window_size)
            # reference reads with boundary fill 0 and rejects any nonzero
            # label (background.py:57-61); our crop fills boundary with -100
            if not np.any((labels != 0) & (labels != LABEL_BOUNDARY_VAL)):
                return [y, x], ech
        _note_give_up(self, "every candidate crop contained fish labels")
        return [y, x], ech


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
