"""Ops of the port: plain PyTorch attention, ring attention over
sequence shards (``ring_attention.py``), losses, optimizers and the
hand-written kernels."""
