"""Production serving walkthrough: weights -> slab-mode survey
prediction -> school detection -> the weights back to the reference ->
the serving artifact.

The port's counterpart of
``crimac_unet_tpu/examples/example_production_serving.py``, with the
recommended serving configuration (``configs/config_serving.yaml``):
  * ``infer_mode: slab`` — one fully-convolutional forward per chunk;
  * BatchNorm folded into the convs (default at inference);
  * ``transfer_dtype: uint8`` — host-side dB transform, 8-bit codes on
    the h2d slab, bf16 compute;
  * the gather_db and relu_pool_skip kernels on the card.

For the artifact alone see ``example_aot_deployment.py``.

Run (synthesizes a small survey; substitute your own store + checkpoint):
  python -m crimac_unet_tpu_torch.examples.example_production_serving \\
      [--device cpu]
"""

import argparse
import tempfile
import warnings


def main(argv=None):
    import numpy as np
    import torch

    from ..data.fixtures import make_zarr_survey
    from ..data.zarr_reader import DataReaderZarr
    from ..data.zarrlite import ZGroup
    from ..models import weights
    from ..models.unet import build_unet, init_random_
    from ..pipeline.predict import save_survey_predictions_zarr
    from ..pipeline.runner import GriddedRunner, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu to run without a card (default: cuda)")
    dev = resolve_device(p.parse_args(argv).device)

    with tempfile.TemporaryDirectory() as tmp:
        sv_path = make_zarr_survey(tmp, year=2019, n_echograms=1,
                                   H=200, W=600, seed=1)
        reader = DataReaderZarr(sv_path)

        cfg = {
            "patch_size": [64, 64], "patch_overlap": 8,
            "frequencies": [18, 38, 120, 200],
            "depth": 2, "start_filts": 8,       # demo-sized model; the
            # flagship is depth 5 / start_filts 64 with patch [256, 256]
            "fwd_batch": 32,
            "compute_dtype": "bfloat16",
            "infer_mode": "slab",               # production serving mode
            "transfer_dtype": "uint8",          # 8-bit dB-code h2d slabs
        }
        # real deployments load weights instead:
        #   state_dict = weights.load_checkpoint(
        #       "saved_models/<run>/best.msgpack")   # or a reference .pt
        model = init_random_(build_unet(cfg),
                             torch.Generator().manual_seed(0))
        state_dict = model.state_dict()

        with warnings.catch_warnings():
            # demo geometry is pooling-aligned; the flagship geometry
            # warns about slab/patch pooling misalignment (expected and
            # documented — DIVERGENCES.md)
            warnings.simplefilter("ignore")
            runner = GriddedRunner(build_unet(cfg), state_dict, cfg,
                                   device=dev)

        # name the store <reader>_pred.zarr up front — the save_predict
        # CLI convention, and what school_eval's from-predictions mode
        # globs for below
        out = f"{tmp}/{reader.name}_pred.zarr"
        save_survey_predictions_zarr(runner, reader, out,
                                     preload_n_pings=300)
        ann = ZGroup.open(out)["annotation"]
        print(f"wrote {out} on {dev}: annotation {ann.shape} {ann.dtype} "
              f"(category [27, 1], reference on-disk contract), "
              f"{runner.forwards} forwards")

        # school-level detection from the store just written — no model
        # or device needed (pipeline/school_eval.py from-predictions
        # mode; also a CLI: crimac-torch-school-eval with
        # school_from_predictions in the YAML)
        from ..pipeline.school_eval import school_eval_survey
        m = school_eval_survey(None, [reader], from_predictions=tmp,
                               prob_threshold=0.2)
        for cname, cm in m["categories"].items():
            print(f"school detection [{cname}]: mean AP "
                  f"{cm['mean_ap']:.3f}, {cm['n_detections']} detections"
                  f" / {cm['n_gt']} annotated schools")

        # ship the weights to the reference stack: the JAX package's
        # variables (a training checkpoint's params + batch_stats) as a
        # reference-loadable state dict
        variables = weights.torch_to_flax_variables(state_dict)
        torch.save(weights.to_tensors(
            weights.flax_to_torch_state_dict(variables)),
            f"{tmp}/export_for_reference.pt")
        build_unet(cfg).load_state_dict(
            torch.load(f"{tmp}/export_for_reference.pt",
                       weights_only=True))
        print("exported reference-loadable state dict: "
              "export_for_reference.pt")

        # the serving artifact: the forward (K1 front end -> folded-BN
        # U-Net -> softmax) as a torch.export program; this config serves
        # in slab mode, so export the matching slab artifact (symbolic,
        # pooling-aligned chunk dims; uint8 dB codes in)
        from ..pipeline.export import (export_slab_predictor,
                                       load_predictor, save_exported)
        from ..pipeline.infer_common import _quantize_db_u8
        save_exported(export_slab_predictor(build_unet(cfg), state_dict,
                                            cfg, device=dev),
                      f"{tmp}/unet_slab.pt2")
        predict = load_predictor(f"{tmp}/unet_slab.pt2", device=dev)
        raw = np.abs(np.random.RandomState(1).standard_normal(
            (1, 128, 320, 4)).astype(np.float32)) * 1e-5
        probs = predict(torch.from_numpy(_quantize_db_u8(raw)).to(dev))
        print(f"slab artifact unet_slab.pt2 on {dev} -> probs "
              f"{tuple(probs.shape)} (symbolic chunk dims, uint8 dB-code "
              f"input)")
    return probs


if __name__ == "__main__":
    main()
