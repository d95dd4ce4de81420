"""Import facade of the gridded prediction and evaluation pipeline.

The port's counterpart of ``crimac_unet_tpu/pipeline/inference.py``: the
implementation is split across infer_common.py (quantization laws,
slab/grid helpers), runner.py (``GriddedRunner`` and the metadata
inputs), predict.py (the chunked predict loop and the zarr/memmap
writers) and eval_gridded.py (the PR-histogram eval loop and keep
masks); the names the JAX facade re-exports are re-exported here from
those modules.

One name of the JAX facade has no counterpart under its name:
``_net_db_input`` (the network-input transform) is
``crimac_unet_tpu_torch.ops.data_ops.net_db_input`` in the port, the
plain version of the gather_db kernel's arithmetic.
"""

from __future__ import annotations

from .infer_common import (DB_U8_SCALE, _U8_PROB_DEQUANT,  # noqa: F401
                           _convert_labels_host, _fill_hwc_slab,
                           _grid_extent_rows, _quantize_db_u8,
                           _quantize_prob_u8, _round_up, _unpack_bits,
                           grid_center_cols, grid_height_for_reader)
from .runner import (GriddedRunner, _build_meta_inputs,  # noqa: F401
                     _build_meta_slab_full)
from .predict import (_ping_chunk, predict_reader,  # noqa: F401
                      save_reader_predictions_memm,
                      save_survey_predictions_zarr,
                      static_grid_shape_for_reader)
from .eval_gridded import _build_keep_mask, evaluate_reader  # noqa: F401

__all__ = [
    "DB_U8_SCALE", "GriddedRunner", "evaluate_reader",
    "grid_center_cols", "grid_height_for_reader", "predict_reader",
    "save_reader_predictions_memm", "save_survey_predictions_zarr",
    "static_grid_shape_for_reader",
]
