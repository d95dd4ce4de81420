"""crimac_unet_tpu_torch — the PyTorch/CUDA port of crimac_unet_tpu.

Runs on an NVIDIA Hopper GPU what the JAX package runs on a TPU:
full-survey prediction of memmap and zarr surveys (patch and slab mode,
the static grid, the serving preset's uint8 transfer, metadata channels)
through the CLI and the docker entry, gridded evaluation and
school-detection AP, training on memmap and zarr surveys with JAX-package
checkpoints, the ``torch.export`` serving artifact, the deployment
self-check and the FLOP / timing / profiling tools.  Host data plane in
numpy, the U-Net in PyTorch, and the patch front end (gather + dB), the
level-0 pooling and the label chain's closing as hand-written CUDA C++
kernels (``csrc/``) built with ``nvcc`` at first use and registered as
``crimac::`` operators.

The package never imports jax, flax, optax, ml_dtypes or anything of
``crimac_unet_tpu``: where it needs one of that package's jax-free
modules it keeps its own copy.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel wrapper uses its
plain PyTorch version.
"""

__version__ = "0.1.0"
