"""Survey partitioning for prediction and evaluation (memmap and zarr).

The evaluation half of the JAX package's ``crimac_unet_tpu/data/
partition.py`` (reference crimac_unet/data/partition.py:29-383): the
``partition_predict`` policies ``selected surveys`` and ``all surveys``
(the hard-coded 2007-2018 evaluation list) and per-survey reader lookup,
for both data modes.  The training split and the sampler battery come
with the training slice.
"""

from __future__ import annotations

from .memmap_reader import get_echograms
from .zarr_reader import get_zarr_readers

EVAL_ALL_SURVEYS = [2007, 2008, 2009, 2010, 2011, 2013, 2014, 2015, 2016,
                    2017, 2018]


class _DataPartition:
    def __init__(self, frequencies, patch_size, partition_predict,
                 evaluation_surveys, eval_mode, patch_overlap=20, **kwargs):
        self.frequencies = sorted(frequencies)
        self.window_size = patch_size
        self.partition_predict = partition_predict
        self.evaluation_surveys = evaluation_surveys
        self.eval_mode = eval_mode
        self.patch_overlap = patch_overlap

    def get_evaluation_surveys(self):
        if self.partition_predict == "all surveys":
            return EVAL_ALL_SURVEYS
        if self.partition_predict == "selected surveys":
            return self.evaluation_surveys
        raise ValueError(f"partition_predict options: 'selected surveys' or "
                         f"'all surveys', not {self.partition_predict}")


class DataMemm(_DataPartition):
    """Memmap-mode partition (reference partition.py:29-190)."""

    def __init__(self, *args, path_to_echograms=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.readers = get_echograms(
            frequencies=self.frequencies,
            minimum_shape=self.window_size[0],
            path_to_echograms=path_to_echograms)

    def get_survey_readers(self, survey):
        return [r for r in self.readers if r.year == survey]


class DataZarr(_DataPartition):
    """Zarr-mode partition (reference partition.py:193-383), evaluation
    half."""

    def __init__(self, *args, path_to_zarr_files=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._zarr_root = path_to_zarr_files

    def get_survey_readers(self, survey):
        # predict/eval discovery: unannotated surveys allowed (degraded
        # prediction-only mode)
        return get_zarr_readers([survey], frequencies=self.frequencies,
                                minimum_shape=self.window_size[0],
                                path_to_zarr_files=self._zarr_root,
                                require_categories=False)


def make_partition(config: dict, **kwargs):
    mode = config["data_mode"]
    if mode == "zarr":
        return DataZarr(**config, **kwargs)
    if mode == "memm":
        return DataMemm(**config, **kwargs)
    raise ValueError("data_mode must be 'zarr' or 'memm'")
