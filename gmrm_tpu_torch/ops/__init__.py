"""Decode, marker statistics and the CUDA kernels of the sweep, each with
its plain PyTorch version."""
