"""Offline preprocessing: per-rawfile MATLAB ``.mat`` -> memmap echogram dir.

Counterpart of reference data_preprocessing/generate_memmap_files.py:18-161.
Each ``.mat`` (from the LSSS/EK60 MATLAB export, keys ``sv`` (H,W,C), ``I``
(H,W) label image, ``F`` frequencies, ``range``, ``t``, ``depths``,
``heave``) becomes a directory of per-frequency ``.dat`` memmaps + pickled
metadata + connected-component school objects.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from scipy import io as spio
from scipy import ndimage

DATA_DTYPE = "float32"
LABEL_DTYPE = "int16"


def _save_memmap(data, path, dtype, overwrite=False):
    path = (path + ".dat").replace(".dat.dat", ".dat")
    if os.path.isfile(path) and not overwrite:
        return
    # atomic publish (same pattern as write_heave_reverted_labels): a
    # kill between the full-size w+ create and the fill used to leave an
    # all-zeros .dat that every later overwrite=False resume accepted as
    # converted data forever
    import tempfile
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".memmap.tmp")
    os.close(fd)
    fp = np.memmap(tmp, dtype=dtype, mode="w+", shape=data.shape)
    fp[:] = data.astype(dtype)
    fp.flush()
    del fp
    os.replace(tmp, path)


def _save_pickle(data, name, out_folder):
    with open(os.path.join(out_folder, name + ".pkl"), "wb") as f:
        pickle.dump(data, f)


def objects_from_label_image(label_img: np.ndarray) -> list:
    """Connected components per fish type -> reference 'objects' dicts
    (generate_memmap_files.py:128-156)."""
    objects = []
    for fish_type_ind in np.unique(label_img):
        if fish_type_ind == 0:
            continue
        labeled_img, n_components = ndimage.label(label_img == fish_type_ind)
        # bounded memory: per-component bbox slices from find_objects +
        # argwhere restricted to each slice, instead of a full-image int64
        # index cube (~4 GB at survey scale) rescanned once per component
        slices = ndimage.find_objects(labeled_img)
        for i in range(1, n_components + 1):
            sl = slices[i - 1]
            local = np.argwhere(labeled_img[sl] == i)
            idx = local + np.array([sl[0].start, sl[1].start])
            bbox = [int(idx[:, 0].min()), int(idx[:, 0].max()),
                    int(idx[:, 1].min()), int(idx[:, 1].max())]
            area = (bbox[1] - bbox[0] + 1) * (bbox[3] - bbox[2] + 1)
            objects.append({
                "fish_type_index": int(fish_type_ind),
                "indexes": idx,
                "n_pixels": int(idx.shape[0]),
                "bounding_box": bbox,
                "labeled_as_segmentation": area != idx.shape[0],
            })
    return objects


def convert_mat_file(in_file, out_folder, overwrite=False) -> int:
    """Convert one .mat file; returns the number of school objects found."""
    os.makedirs(out_folder, exist_ok=True)
    mat = spio.loadmat(in_file)

    # ravel, not squeeze: a single-frequency file's F is (1, 1) and
    # squeeze() gives a 0-d array enumerate() cannot iterate.  MATLAB
    # also drops trailing singleton dims, so that file's sv arrives 2-D
    # — restore the channel axis before indexing
    sv = np.asarray(mat["sv"])
    if sv.ndim == 2:
        sv = sv[:, :, None]
    mat["sv"] = sv
    for i, f in enumerate(np.asarray(mat["F"]).ravel()):
        _save_memmap(sv[:, :, i],
                     os.path.join(out_folder, f"data_for_freq_{int(f)}"),
                     DATA_DTYPE, overwrite)
    _save_memmap(mat["I"], os.path.join(out_folder, "labels"), LABEL_DTYPE,
                 overwrite)

    _save_pickle(mat["F"], "frequencies", out_folder)
    _save_pickle(mat["range"], "range_vector", out_folder)
    _save_pickle(mat["t"], "time_vector", out_folder)
    _save_pickle(DATA_DTYPE, "data_dtype", out_folder)
    _save_pickle(LABEL_DTYPE, "label_dtype", out_folder)
    _save_pickle(mat["sv"][:, :, 0].shape, "shape", out_folder)
    if "depths" in mat:
        _save_pickle(mat["depths"], "depths", out_folder)
    _save_pickle(mat.get("heave",
                         np.zeros(mat["sv"].shape[1])), "heave", out_folder)

    objects = objects_from_label_image(mat["I"])
    _save_pickle(objects, "objects", out_folder)
    return len(objects)


def convert_survey_tree(path_to_mat_files, overwrite=False) -> list:
    """Walk ``<root>/<year>/*.mat`` and convert everything into
    ``<root>/memmap/<rawfile>/`` (generate_memmap_files.py:88-112)."""
    out_root = os.path.join(path_to_mat_files, "memmap")
    os.makedirs(out_root, exist_ok=True)
    converted = []
    for year_dir in sorted(os.listdir(path_to_mat_files)):
        if year_dir in ("Thumbs.db", "memmap"):
            continue
        filedir = os.path.join(path_to_mat_files, year_dir)
        if not os.path.isdir(filedir):
            # flat layout: ek60.convert_survey_raw writes its .mat files
            # directly into the scratch dir — the documented chain
            # convert_survey_raw -> convert_survey_tree was a silent
            # no-op without this
            if year_dir.endswith(".mat") and "datastatus" not in year_dir:
                name = os.path.splitext(year_dir)[0]
                try:
                    convert_mat_file(os.path.join(path_to_mat_files,
                                                  year_dir),
                                     os.path.join(out_root, name),
                                     overwrite)
                    converted.append(name)
                except Exception as exc:
                    print(f"Could not convert {year_dir}: {exc}")
            continue
        for file in sorted(os.listdir(filedir)):
            if not file.endswith(".mat") or "datastatus" in file:
                continue
            name = os.path.splitext(file)[0]
            try:
                convert_mat_file(os.path.join(filedir, file),
                                 os.path.join(out_root, name), overwrite)
                converted.append(name)
            except Exception as exc:
                print(f"Could not convert {file}: {exc}")
    return converted
