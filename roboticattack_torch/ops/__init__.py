"""Ops of the port: plain attention and the hand-written CUDA kernels with
their plain PyTorch versions."""
