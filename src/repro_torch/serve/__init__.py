from .khi_service import KHIService, Request, Result, ServeConfig  # noqa: F401
from .faults import FaultInjector, FaultSpec, InjectedFault  # noqa: F401
from .scheduler import (  # noqa: F401
    Rejected, SchedulerConfig, Served, SLOScheduler, TierSpec,
    replay_open_loop,
)
