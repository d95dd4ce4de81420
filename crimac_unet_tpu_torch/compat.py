"""Reference-name compatibility layer.

Users migrating from `CRIMAC-classifiers-unet` can import the familiar
names from here; each maps to the port's equivalent, with the JAX
package's ``crimac_unet_tpu/compat.py`` export list.  The models' names
map onto the port's objects: ``UNet`` is the torch module,
``load_torch_checkpoint`` / ``torch_state_dict_to_flax`` /
``save_torch_checkpoint`` go through models/weights.py, and the
pipeline's ``GriddedRunner`` runs the CUDA kernels on the card.
"""

# L0 — config / paths
from .config import (config_args_to_markdown, get_argparse_parser,
                     get_experiment_name_from_args, load_yaml_config,
                     parse_config_options)
from .utils.general import fix_seeds, get_datetime_str

# L1 — readers
from .data.memmap_reader import Echogram, get_echograms
from .data.zarr_reader import DataReaderZarr, get_zarr_readers


def get_data_readers(years="all", frequencies=(18, 38, 120, 200),
                     minimum_shape=50, mode="zarr", **kw):
    """(reference data/data_reader.py:1190-1194)"""
    if mode == "memm":
        return get_echograms(years=years, frequencies=frequencies,
                             minimum_shape=minimum_shape, **kw)
    return get_zarr_readers(years, frequencies, minimum_shape, **kw)


# L2 — partitioning
from .data.partition import DataMemm, DataZarr  # noqa: E402

# L3 — samplers
from .data.samplers import (Background, BackgroundSeabed,  # noqa: E402
                            BackgroundSeabedZarr, BackgroundZarr, Gridded,
                            School, SchoolSeabed, SchoolSeabedZarr,
                            SchoolZarr, Seabed, SeabedZarr)
from .ops.patches import grid_centers as get_data_grid_centers  # noqa: E402

# L4 — dataset / transforms (host batch production + device ops)
from .data.dataset import BatchPrefetcher  # noqa: E402
from .data.dataset import RandomPatchDataset as Dataset  # noqa: E402
from .ops import augment, data_ops, label_ops  # noqa: E402
from .ops.data_ops import (db, db_with_limits,  # noqa: E402
                           db_with_limits_scaled, remove_nan_inf,
                           set_data_border_value)
from .ops.label_ops import (convert_label_indexing,  # noqa: E402
                            mask_label_overlap, mask_label_seabed,
                            refine_label_boundary, set_label_ignore_val)

# L5 — models
from .models.unet import UNet, UNet as UNet_Baseline, build_unet  # noqa
from .models.weights import (load_torch_checkpoint,  # noqa: E402
                             save_torch_checkpoint)
from .models.weights import (  # noqa: E402
    torch_to_flax_variables as torch_state_dict_to_flax)

# L6 — pipeline engine
from .pipeline.segpipe import SegPipeUNet  # noqa: E402
from .pipeline.inference import (GriddedRunner,  # noqa: E402
                                 evaluate_reader, predict_reader,
                                 save_reader_predictions_memm,
                                 save_survey_predictions_zarr)
from .data.meta_channels import get_in_channels  # noqa: E402

# aux
from .utils.combine_functions import CombineFunctions  # noqa: E402
from .utils.preload_split import get_data_split  # noqa: E402
from .utils.interp import (get_grid as getGrid,  # noqa: E402
                           linear_interpolation, nearest_interpolation)
from .utils.grids import (patch_coord_to_data_coord,  # noqa: E402
                          random_point_containing)
