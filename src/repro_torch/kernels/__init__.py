"""Kernels of the PyTorch port.

Each of the six kernels the JAX package wrote in Pallas for the TPU is
written here by hand for Hopper (CUDA C++ under ``csrc/``), with a plain
PyTorch version beside it: the wrapper launches the kernel for CUDA
tensors and runs the plain version for CPU tensors.  Sources are compiled
on first use (``cuda_build``), never at import.

* ``paged_attention`` -- K1, LNS paged decode attention;
* ``lns_matmul``      -- K2 (fused dequant), K3 (the paper's LNS matmul)
                         and K4 (K3's sequential seed form);
* ``fp8_elementwise`` -- K5, the paper's six FP8 operations;
* ``flash_attention`` -- K6, tiled online-softmax attention on float
                         inputs, with its tiling from ``autotune``.
"""
