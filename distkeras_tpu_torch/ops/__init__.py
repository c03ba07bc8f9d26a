"""Ops of the port: plain PyTorch attention and the hand-written kernels."""
