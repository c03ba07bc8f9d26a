"""Op-level compute attribution (port of ``distkeras_tpu/profiling``):
the cost model (an eager call's aten ops and kernel launches, costed),
the roofline classifier and the measured capture (``torch.profiler``).

Layering as in the JAX package: nothing under ``health/`` or
``telemetry.py`` imports this package; results flow out as
``profile.op.*`` metrics and a digest on the flight recorder.
"""

from distkeras_tpu_torch.profiling.cost_model import (  # noqa: F401
    OpCost, OpInventory, op_inventory, source_inventory)
from distkeras_tpu_torch.profiling.roofline import (  # noqa: F401
    HBM_BANDWIDTH, RooflineReport, build_report, classify,
    device_hbm_bandwidth)
from distkeras_tpu_torch.profiling.capture import (  # noqa: F401
    OpTimeTable, capture_op_times)
