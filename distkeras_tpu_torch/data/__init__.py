"""The data path of the port: the columnar ``Dataset``, background
prefetch and the native batch assembler (``native.py``). ``GlobalShards``
and the data service wait for ROADMAP.md Queue A, item 16."""

from distkeras_tpu_torch.data.dataset import (Dataset, PermutedColumn,
                                              ShardedColumn, synthetic_mnist)
from distkeras_tpu_torch.data.prefetch import prefetch

__all__ = ["Dataset", "PermutedColumn", "ShardedColumn", "prefetch",
           "synthetic_mnist"]
