"""Executable walkthrough of the sampler battery + on-device transform chain
(counterpart of reference examples/example_samplers.py:67-124).

The port's counterpart of ``crimac_unet_tpu/examples/example_samplers.py``:
the six samplers draw crops on the host, and the train chain (noise and
flip, the label-boundary refinement through the binary_closing kernel,
label indexing, dB) runs on the device:

    python -m crimac_unet_tpu_torch.examples.example_samplers [--device cpu]
"""

import argparse
import tempfile

import numpy as np


def main(argv=None):
    import torch

    from ..data.dataset import RandomPatchDataset
    from ..data.fixtures import make_survey_dir
    from ..data.memmap_reader import get_echograms
    from ..data.partition import SAMPLER_PROBS
    from ..data import samplers as S
    from ..ops import augment, data_ops, label_ops
    from ..pipeline.runner import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu to run without a card (default: cuda)")
    dev = resolve_device(p.parse_args(argv).device)

    tmp = tempfile.mkdtemp()
    make_survey_dir(tmp, year=2017, n_echograms=2, H=120, W=300, seed=1)
    readers = get_echograms(years=[2017], path_to_echograms=tmp,
                            minimum_shape=100)
    window = [64, 64]
    half = window[0] // 2

    battery = [
        S.Background(readers, window),
        S.Seabed(readers, window),
        S.School(readers, window, 27),
        S.School(readers, window, 1),
        S.SchoolSeabed(readers, window, max_dist_to_seabed=half,
                       fish_type=27),
        S.SchoolSeabed(readers, window, max_dist_to_seabed=half,
                       fish_type=1),
    ]
    names = ["Background", "Seabed", "School(27)", "School(1)",
             "SchoolSeabed(27)", "SchoolSeabed(1)"]
    rng = np.random.RandomState(0)
    for name, sampler in zip(names, battery):
        center, ech = sampler.get_sample(rng)
        labels = ech.crop_labels(center, window)
        uniq = np.unique(labels)
        print(f"{name:<18s} center={center} echogram={ech.name} "
              f"labels={uniq.tolist()}")

    ds = RandomPatchDataset(battery, window, [18, 38, 120, 200],
                            sampler_probs=SAMPLER_PROBS, seed=0)
    batch = ds.batch(4)
    print("\nBatch:", {k: v.shape for k, v in batch.items()})

    # the train transform chain on the device
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.from_numpy(batch["data"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    data, labels = augment.augment_train(gen, data, labels)
    labels = label_ops.refine_label_boundary(data, labels)
    labels = label_ops.convert_label_indexing(labels)
    data, labels = data_ops.data_transform_train(data, labels)
    print(f"After the chain on {dev}: data dB range "
          f"[{float(data.min()):.1f}, {float(data.max()):.1f}], "
          f"label values {torch.unique(labels).tolist()}")
    return data, labels


if __name__ == "__main__":
    main()
