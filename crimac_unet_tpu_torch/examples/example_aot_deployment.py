"""AOT deployment walkthrough: weights -> ``torch.export`` artifact ->
serving host.

The port's counterpart of
``crimac_unet_tpu/examples/example_aot_deployment.py``.  The serving
forward is exported ONCE (pipeline/export.py); the serving host needs
torch and this package (for the ``crimac::`` kernel operators), but no
model source, config or checkpoint:

  * exporter side: ``export_checkpoint(ckpt, config, out)`` (or
    ``python -m crimac_unet_tpu_torch.pipeline.export``) — with the
    serving preset's settings the artifact takes uint8 dB codes
    (``transfer_dtype: uint8``) and returns uint8 probability codes
    (``output_dtype: uint8``: round(p * 255), dequant = code / 255); slab
    mode gives symbolic pooling-aligned chunk dimensions;
  * serving side: ``load_predictor(path)`` plus the host quantizer
    ``_quantize_db_u8`` (round((clip(dB, -75, 0) + 75) * 255 / 75)).

Run (synthesizes everything; substitute your own checkpoint and stores):
  python -m crimac_unet_tpu_torch.examples.example_aot_deployment \\
      [--device cpu]
"""

import argparse
import tempfile
from pathlib import Path


def main(argv=None):
    import numpy as np
    import torch

    from ..models.unet import build_unet, init_random_
    from ..pipeline.export import (export_slab_predictor, load_predictor,
                                   save_exported)
    from ..pipeline.infer_common import _quantize_db_u8
    from ..pipeline.runner import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu to run without a card (default: cuda)")
    dev = resolve_device(p.parse_args(argv).device)

    # ---- exporter side (has the package and the weights) --------------
    cfg = {
        "patch_size": [64, 64], "frequencies": [18, 38, 120, 200],
        "depth": 2, "start_filts": 8,     # demo-sized; flagship is 5/64
        "compute_dtype": "bfloat16",
        "infer_mode": "slab",             # whole-chunk forward
        "transfer_dtype": "uint8",        # serving preset: dB codes in
        "output_dtype": "uint8",          # serving preset: codes out
    }
    model = init_random_(build_unet(cfg), torch.Generator().manual_seed(0))
    # real deployments: state_dict = models.weights.load_checkpoint(path)
    state_dict = model.state_dict()

    with tempfile.TemporaryDirectory() as tmp:
        artifact = Path(tmp) / "unet_serving.pt2"
        save_exported(export_slab_predictor(build_unet(cfg), state_dict,
                                            cfg, device=dev), artifact)
        print(f"exported {artifact.name}: "
              f"{artifact.stat().st_size / 1e6:.1f} MB")

        # ---- serving side (torch + this package + the artifact) -------
        predict = load_predictor(artifact, device=dev)

        # a raw sv chunk as a reader hands it over (range x ping must be
        # multiples of 2**(depth-1), the slab alignment)
        rng = np.random.RandomState(7)
        sv_chunk = rng.lognormal(np.log(1e-6), 2.5,
                                 (1, 128, 256, 4)).astype(np.float32)
        sv_chunk[0, 10:14, 30:50, :] = np.nan     # dropouts ride as code 0

        codes = _quantize_db_u8(sv_chunk)         # the whole host-side prep
        out = predict(torch.from_numpy(codes).to(dev)).cpu().numpy()
        assert out.dtype == np.uint8
        probs = out.astype(np.float32) / 255.0    # the dequant contract
        assert probs.shape == (1, 128, 256, 3)
        assert np.isfinite(probs).all()
        assert np.allclose(probs.sum(-1), 1.0, atol=2 / 255 + 1e-3)
        print(f"served chunk {sv_chunk.shape} on {dev} as "
              f"{codes.nbytes / 1e3:.0f} kB of uint8 codes "
              f"({sv_chunk.nbytes / codes.nbytes:.0f}x fewer bytes than "
              f"float32); sandeel prob range "
              f"[{probs[..., 1].min():.3f}, {probs[..., 1].max():.3f}]")
    return probs


if __name__ == "__main__":
    main()
