"""Parameter-dict arithmetic (port of the parts of
``distkeras_tpu/utils/trees.py`` the step engine uses). A "tree" here is
a mapping of names to tensors, as ``dict(model.named_parameters())``."""

from __future__ import annotations

from typing import Mapping

import torch


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over all leaves, each squared and summed in float32
    (the grad-norm metric). A 0-d float32 tensor on the leaves' device."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(total)
