"""Executable walkthrough of the zarr survey reader
(counterpart of reference examples/example_zarr_reader.py:25-63).

The port's counterpart of
``crimac_unet_tpu/examples/example_zarr_reader.py``; the objects table is
a dict of numpy columns (no pandas), and the last step shows the network
input of one patch of the survey as the gather_db kernel makes it on the
device.  Runs self-contained on a synthetic survey:

    python -m crimac_unet_tpu_torch.examples.example_zarr_reader \\
        [survey_sv.zarr] [--device cpu]
"""

import argparse
import tempfile

import numpy as np


def main(argv=None):
    import torch

    from ..ops.gather_db import gather_db
    from ..pipeline.runner import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sv_path", nargs="?", default=None,
                   help="a <survey>_sv.zarr store (default: synthetic)")
    p.add_argument("--device", default=None,
                   help="cpu to run without a card (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    sv_path = args.sv_path
    if sv_path is None:
        from ..data.fixtures import make_zarr_survey
        tmp = tempfile.mkdtemp()
        sv_path = make_zarr_survey(tmp, year=2017, n_echograms=2, H=100,
                                   W=300, seed=0)
        print(f"(no survey given; generated a synthetic one at {sv_path})")

    from ..data.zarr_reader import DataReaderZarr
    reader = DataReaderZarr(sv_path)

    print("Survey:", reader.name, "| year:", reader.year)
    print("Shape (pings, range):", reader.shape)
    print("Frequencies:", list(reader.frequencies))
    print("Fish categories:", reader.fish_categories)
    print("Valid ping ranges:", reader.get_valid_pings().tolist())

    n = min(100, reader.shape[0])
    slab = reader.get_data_slice(idx_ping=0, n_pings=n)
    print("Data slice (freq, ping, range):", slab.shape,
          "| sv range: %.3g .. %.3g" % (np.nanmin(slab), np.nanmax(slab)))

    labels = reader.get_label_slice(0, n)
    uniq, counts = np.unique(labels[np.isfinite(labels)],
                             return_counts=True)
    print("Label histogram:", dict(zip(uniq.tolist(), counts.tolist())))

    seabed = reader.get_seabed(0, n)
    print("Seabed rows (first 10 pings):", seabed[:10].tolist())

    schools = reader.get_fish_schools()
    n_schools = len(schools["category"])
    print(f"{n_schools} valid schools; first rows:")
    for i in range(min(3, n_schools)):
        print("  " + ", ".join(f"{k}={v[i]}" for k, v in schools.items()))

    # the network's view of the slice: one (64, 64) window of the
    # (range, ping, freq) slab, non-finite values scrubbed, dB, clipped
    hwc = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(2, 1, 0), dtype=np.float32)).to(dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    win = min(64, hwc.shape[0], hwc.shape[1])
    patch = gather_db(hwc, zero, zero, (win, win))
    print(f"gather_db patch on {dev}: {tuple(patch.shape)} "
          f"{str(patch.dtype).replace('torch.', '')}, dB "
          f"[{float(patch.min()):.1f}, {float(patch.max()):.1f}]")
    return reader


if __name__ == "__main__":
    main()
