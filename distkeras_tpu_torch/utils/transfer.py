"""Host <-> device moves of whole trees, one synchronization each.

The true-async plane moves a center or a delta between the card and the
wire once a window. Leaf by leaf, ``tensor.cpu()`` would synchronize once
a leaf; :func:`to_host` queues every device-to-host copy into pinned
memory and waits once. :func:`to_device` stages numpy leaves (a decoded
wire blob is a read-only view of the received bytes) in pinned memory
and queues one non-blocking copy a leaf on the current stream, which
orders them before any later work on that stream.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.utils.trees import tree_flatten, tree_unflatten


def to_host(tree):
    """The tree with every tensor leaf as a numpy array (other leaves as
    ``np.asarray``). CUDA leaves are copied into pinned memory with
    ``non_blocking`` and read after one stream synchronization."""
    leaves, treedef = tree_flatten(tree)
    out, pending = [], set()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.device.type == "cuda":
                pending.add(leaf.device)
                out.append(leaf.to("cpu", non_blocking=True))
            else:
                out.append(leaf)
        else:
            out.append(np.asarray(leaf))
    for device in pending:
        torch.cuda.current_stream(device).synchronize()
    return tree_unflatten(treedef, [
        x.numpy() if isinstance(x, torch.Tensor) else x for x in out])


def to_device(tree, device):
    """The tree with every leaf as a tensor on ``device``. Numpy leaves
    bound for a card go through pinned memory and a non-blocking copy on
    the current stream; tensors already there are passed through."""
    device = torch.device(device)
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.to(device))
            continue
        arr = np.asarray(leaf)
        if device.type == "cuda":
            pinned = torch.empty(arr.shape, dtype=torch.from_numpy(
                np.empty(0, arr.dtype)).dtype, pin_memory=True)
            pinned.numpy()[...] = arr
            out.append(pinned.to(device, non_blocking=True))
        else:
            out.append(torch.from_numpy(np.array(arr)))
    return tree_unflatten(treedef, out)
