"""KHI on PyTorch: the partitioning tree, the graph builders (Algorithm 5
in ``hnsw``, the bulk and device builders), the batched two-phase search
and the selectivity-adaptive planner; the baselines are in
``baselines``. The names are the reference package's (``repro.core``).
``query`` and ``estimate_cardinality`` are the paper's Algorithms 1-3 on
the host (``query_ref``), the oracle the batched engine is held to."""

from .khi import KHIConfig, KHIIndex  # noqa: F401
from .query_ref import (  # noqa: F401
    Predicate,
    StreamingOracle,
    brute_force,
    brute_force_expr,
    estimate_cardinality,
    query,
)
from .predicate import (  # noqa: F401
    And,
    Eq,
    In,
    Not,
    Or,
    Range,
    PredicateProgram,
    compile_expr,
    eval_expr,
    normalize,
    parse_expr,
    validate_expr,
)
from .build_device import build_graphs_device  # noqa: F401
from .delta import DeltaSegment, StreamingState  # noqa: F401
from .engine import (  # noqa: F401
    BACKENDS,
    ROUTERS,
    STRATEGIES,
    DeviceIndex,
    Plan,
    Planner,
    PredicatePlan,
    Scorer,
    SearchParams,
    derive_search_params,
    device_put_index,
    make_search_fn,
    resolve_scorer,
    search_batch,
    validate_search_params,
)
