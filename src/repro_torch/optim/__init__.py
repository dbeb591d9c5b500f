from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    opt_logical_axes,
    schedule,
)
