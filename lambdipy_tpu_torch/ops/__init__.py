"""Kernels of the port: each module holds a plain PyTorch version, the
wrapper that launches the hand-written CUDA kernel, and the wrapper's
launch counter."""
