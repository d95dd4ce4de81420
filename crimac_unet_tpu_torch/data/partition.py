"""Survey partitioning into train/validation/evaluation sets (memmap and
zarr).

The port's counterpart of ``crimac_unet_tpu/data/partition.py`` (reference
crimac_unet/data/partition.py:29-383): the ``partition_predict`` policies
``selected surveys`` and ``all surveys`` (the hard-coded 2007-2018
evaluation list) and per-survey reader lookup for both data modes, and
the training split (``partition_train``: ``random`` 85/15 at the fixed
seed 10, ``selected surveys``, ``all surveys``) with the six-sampler
battery (probabilities [1, 5, 5, 5, 5, 5]) in its memmap or zarr form.
"""

from __future__ import annotations

import numpy as np

from . import samplers as S
from .memmap_reader import get_echograms
from .zarr_reader import get_zarr_readers

EVAL_ALL_SURVEYS = [2007, 2008, 2009, 2010, 2011, 2013, 2014, 2015, 2016,
                    2017, 2018]
SAMPLER_PROBS = [1, 5, 5, 5, 5, 5]
_PARTITIONS = ("random", "selected surveys", "all surveys")


class _DataPartition:
    def __init__(self, frequencies, patch_size, partition_predict,
                 evaluation_surveys, eval_mode, patch_overlap=20,
                 partition_train="selected surveys", train_surveys=(),
                 validation_surveys=(), **kwargs):
        self.frequencies = sorted(frequencies)
        self.window_size = patch_size
        self.partition_predict = partition_predict
        self.evaluation_surveys = evaluation_surveys
        self.eval_mode = eval_mode
        self.patch_overlap = patch_overlap
        self.partition_train = partition_train
        self.train_surveys = train_surveys
        self.validation_surveys = validation_surveys

    def get_evaluation_surveys(self):
        if self.partition_predict == "all surveys":
            return EVAL_ALL_SURVEYS
        if self.partition_predict == "selected surveys":
            return self.evaluation_surveys
        raise ValueError(f"partition_predict options: 'selected surveys' or "
                         f"'all surveys', not {self.partition_predict}")

    def _check_partition(self):
        if self.partition_train not in _PARTITIONS:
            raise ValueError(f"unknown partition_train "
                             f"{self.partition_train!r}; expected one of "
                             f"{sorted(_PARTITIONS)}")

    def _sampler_battery(self, readers, sampler_types):
        (Bg, Sb, Sc, ScSb) = sampler_types
        half = self.window_size[0] // 2
        return [
            Bg(readers, self.window_size),
            Sb(readers, self.window_size),
            Sc(readers, self.window_size, 27),
            Sc(readers, self.window_size, 1),
            ScSb(readers, self.window_size, max_dist_to_seabed=half,
                 fish_type=27),
            ScSb(readers, self.window_size, max_dist_to_seabed=half,
                 fish_type=1),
        ]

    def get_samplers_train(self, readers_train=None, readers_test=None):
        if readers_train is None or readers_test is None:
            readers_train, readers_test = self.partition_data_train()
        return (self._sampler_battery(readers_train, self.SAMPLERS),
                self._sampler_battery(readers_test, self.SAMPLERS),
                list(SAMPLER_PROBS))


class DataMemm(_DataPartition):
    """Memmap-mode partition (reference partition.py:29-190)."""

    SAMPLERS = (S.Background, S.Seabed, S.School, S.SchoolSeabed)

    def __init__(self, *args, path_to_echograms=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.readers = get_echograms(
            frequencies=self.frequencies,
            minimum_shape=self.window_size[0],
            path_to_echograms=path_to_echograms)

    def partition_data_train(self):
        self._check_partition()
        if self.partition_train == "random":
            readers = list(self.readers)
            rng = np.random.RandomState(10)  # fixed split seed
            rng.shuffle(readers)
            cut = int(0.85 * len(readers))
            train, test = readers[:cut], readers[cut:]
        elif self.partition_train == "selected surveys":
            train = [r for r in self.readers if r.year in self.train_surveys]
            test = [r for r in self.readers
                    if r.year in self.validation_surveys]
            # empty survey lists would otherwise fail deep inside the
            # sampler battery with a misleading 'fish_type not found'
            if not train or not test:
                raise ValueError(
                    "partition_train='selected surveys' selected "
                    f"{len(train)} train / {len(test)} validation readers "
                    f"(train_surveys={self.train_surveys}, "
                    f"validation_surveys={self.validation_surveys}, "
                    f"available years="
                    f"{sorted({r.year for r in self.readers})}); set the "
                    "survey-year lists in the config")
        else:  # all surveys
            train = self.readers
            test = [r for r in self.readers if r.year == 2017]
        return train, test

    def get_survey_readers(self, survey):
        return [r for r in self.readers if r.year == survey]


class DataZarr(_DataPartition):
    """Zarr-mode partition (reference partition.py:193-383)."""

    SAMPLERS = (S.BackgroundZarr, S.SeabedZarr, S.SchoolZarr,
                S.SchoolSeabedZarr)

    def __init__(self, *args, path_to_zarr_files=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._zarr_root = path_to_zarr_files

    def _readers(self, years, require_categories=True):
        return get_zarr_readers(years, frequencies=self.frequencies,
                                minimum_shape=self.window_size[0],
                                path_to_zarr_files=self._zarr_root,
                                require_categories=require_categories)

    def partition_data_train(self):
        # training discovery keeps the strict category filter: an
        # unannotated survey has no objects table to sample from
        self._check_partition()
        if self.partition_train == "random":
            readers = self._readers("all")
            rng = np.random.RandomState(10)
            rng.shuffle(readers)
            cut = int(0.85 * len(readers))
            train, test = readers[:cut], readers[cut:]
        elif self.partition_train == "selected surveys":
            train = self._readers(self.train_surveys)
            test = self._readers(self.validation_surveys)
            if not train or not test:
                raise ValueError(
                    "partition_train='selected surveys' selected "
                    f"{len(train)} train / {len(test)} validation "
                    f"readers (train_surveys={self.train_surveys}, "
                    f"validation_surveys={self.validation_surveys}); "
                    "set the survey-year lists in the config")
        else:
            train = self._readers(list(range(2007, 2019)))
            test = [r for r in train if r.year == 2017]
        return train, test

    def get_survey_readers(self, survey):
        # predict/eval discovery: unannotated surveys allowed (degraded
        # prediction-only mode)
        return self._readers([survey], require_categories=False)


def make_partition(config: dict, **kwargs):
    mode = config["data_mode"]
    if mode == "zarr":
        return DataZarr(**config, **kwargs)
    if mode == "memm":
        return DataMemm(**config, **kwargs)
    raise ValueError("data_mode must be 'zarr' or 'memm'")
