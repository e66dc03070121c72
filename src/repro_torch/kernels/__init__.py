"""Kernels of the PyTorch port.

Each kernel the JAX package wrote in Pallas for the TPU is written here by
hand for Hopper (CUDA C++ under ``csrc/``), with a plain PyTorch version
beside it: the wrapper launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  Sources are compiled on first use
(``cuda_build``), never at import.
"""
