"""The data path of the port: the columnar ``Dataset``, background
prefetch, the native batch assembler (``native.py``), ``GlobalShards``
(per-epoch shard re-dealing) and the streaming data service
(``service.py``: a coordinator leasing row ranges to workers)."""

from distkeras_tpu_torch.data.dataset import (Dataset, PermutedColumn,
                                              ShardedColumn, synthetic_mnist)
from distkeras_tpu_torch.data.global_shards import GlobalShards, ShardingError
from distkeras_tpu_torch.data.prefetch import prefetch
from distkeras_tpu_torch.data.service import (DataCoordinator,
                                              DataServiceClient,
                                              DataServiceUnavailable,
                                              stream_ranges)

__all__ = ["DataCoordinator", "DataServiceClient", "DataServiceUnavailable",
           "Dataset", "GlobalShards", "PermutedColumn", "ShardedColumn",
           "ShardingError", "prefetch", "stream_ranges", "synthetic_mnist"]
