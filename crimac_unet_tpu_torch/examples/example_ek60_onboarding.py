"""Executable walkthrough of the raw-data onboarding chain:
EK60 .raw (+ .bot bottom + LSSS .snap labels) -> .mat-contract arrays ->
memmap echogram dir -> Echogram reader -> a prediction of the onboarded
echogram on the device (the pipeline the reference runs through ~940 LoC
of offline MATLAB, data_preprocessing/generate_mat_*.m).

The port's counterpart of
``crimac_unet_tpu/examples/example_ek60_onboarding.py``.  The onboarding
needs numpy and scipy only; the prediction runs a demo-sized U-Net with
seeded random weights through ``GriddedRunner`` (the gather_db and
relu_pool_skip kernels on the card).  Runs self-contained on synthetic
datagram streams:

    python -m crimac_unet_tpu_torch.examples.example_ek60_onboarding \\
        [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    import torch

    from ..data import ek60
    from ..data.mat_to_memmap import convert_mat_file
    from ..data.memmap_reader import Echogram
    from ..models.unet import build_unet, init_random_
    from ..pipeline.predict import predict_reader
    from ..pipeline.runner import GriddedRunner, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu to run without a card (default: cuda)")
    dev = resolve_device(p.parse_args(argv).device)

    tmp = tempfile.mkdtemp()
    rng = np.random.RandomState(0)
    times = 1.5e9 + np.arange(40) * 1.0

    # 1. synthesize a raw survey file trio (in production these come from
    #    the echosounder + LSSS interpretation)
    sv = rng.lognormal(np.log(1e-6), 1.0, (80, 40, 4))
    raw = ek60.write_raw_fixture(os.path.join(tmp, "demo.raw"), sv,
                                 [18, 38, 120, 200], times,
                                 heave=0.2 * rng.randn(40))
    dr = 1500.0 * 1e-4 / 2.0
    bot = ek60.write_bot_fixture(os.path.join(tmp, "demo.bot"), times,
                                 np.full((40, 4), 70 * dr))
    snap = ek60.write_snap_fixture(os.path.join(tmp, "demo.snap"), [{
        "x": [5, 20, 20, 5],
        "y": np.array([20 * dr, 20 * dr, 40 * dr, 40 * dr]) + 5.0,
        "species": [(27, 1.0)],
    }])
    print("raw bytes:", os.path.getsize(raw), "| bot:",
          os.path.getsize(bot), "| snap:", os.path.getsize(snap))

    # 2. parse + convert + assemble onto the common grid
    arrays = ek60.raw_to_arrays(raw, bot_path=bot, snap_path=snap,
                                range_frequency=200)
    print("keys:", sorted(arrays))
    print("sv:", arrays["sv"].shape, "| labeled px:",
          int((arrays["I"] > 0).sum()), "| range max:",
          float(arrays["range"][-1]))

    # 3. write the .mat contract and feed the memmap converter
    mat = ek60.raw_to_matfile(raw, os.path.join(tmp, "demo.mat"),
                              bot_path=bot, snap_path=snap,
                              range_frequency=200)
    out_dir = os.path.join(tmp, "2017843-D20170427-T062615")
    os.makedirs(out_dir)
    n_schools = convert_mat_file(mat, out_dir)
    print("converted to", out_dir, "| school objects:", n_schools)

    # 4. the result is a standard echogram dir
    e = Echogram(out_dir)
    print("Echogram shape (range, ping):", e.shape, "| freqs:",
          list(e.frequencies.astype(int)))
    print("seabed row at ping 0:", int(e.get_seabed(0, 1)[0]))

    # 5. predict it on the device (demo-sized model; the flagship is
    #    depth 5 / start_filts 64 with patch [256, 256])
    cfg = {"patch_size": [32, 32], "patch_overlap": 4,
           "frequencies": [18, 38, 120, 200], "depth": 2,
           "start_filts": 8, "compute_dtype": "float32", "fwd_batch": 16}
    model = init_random_(build_unet(cfg), torch.Generator().manual_seed(0))
    runner = GriddedRunner(build_unet(cfg), model.state_dict(), cfg,
                           device=dev)
    written = 0
    for _s, _e, pred, _lab in predict_reader(runner, e,
                                             preload_n_pings=1000):
        written += int((pred[0] != 0).sum())
    print(f"predicted on {dev}: {runner.forwards} forward(s), "
          f"{written} written px")
    return e


if __name__ == "__main__":
    main()
