# Developer entry points.

.PHONY: test native bench clean test-torch kernels image-torch

test:
	python -m pytest tests/ -q

native:
	$(MAKE) -C crimac_unet_tpu/native

bench:
	python bench.py

# the PyTorch port: its CPU tests, its CUDA kernels (nvcc, no card
# needed), its production image
test-torch:
	python -m pytest tests/test_torch_*.py -q

kernels:
	python -c "from crimac_unet_tpu_torch.ops import cuda_lib; print(cuda_lib.build())"

image-torch:
	docker build -f Dockerfile.torch -t crimac-unet-tpu-torch .

clean:
	$(MAKE) -C crimac_unet_tpu/native clean
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
