"""PyTorch/CUDA port of ivid_tpu: multiview RGBD scene generation on NVIDIA GPUs.

The module layout mirrors ``ivid_tpu`` so each counterpart is easy to find.
Hand-written CUDA kernels live in ``csrc/`` and build at first use
(``cuda_build``); importing the package needs neither nvcc nor a GPU, and it
never imports JAX.
"""
