"""KHI on PyTorch: the partitioning tree, the device graph builder, the
batched two-phase search and the selectivity-adaptive planner."""

from .khi import KHIConfig, KHIIndex  # noqa: F401
from .query_ref import Predicate, brute_force  # noqa: F401
from .build_device import build_graphs_device  # noqa: F401
from .engine import (  # noqa: F401
    BACKENDS,
    ROUTERS,
    STRATEGIES,
    DeviceIndex,
    Plan,
    Planner,
    Scorer,
    SearchParams,
    derive_search_params,
    device_put_index,
    make_search_fn,
    resolve_scorer,
    search_batch,
    validate_search_params,
)
