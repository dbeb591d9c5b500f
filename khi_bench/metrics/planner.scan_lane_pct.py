"""planner.scan_lane_pct: lanes the planner sent to the exact scan over
the lanes the service dispatched (``snapshot()`` counters)."""


def read(ctx):
    s = ctx["snapshot"]
    if not ctx.get("trace") or not s["device_queries"]:
        return None
    return 100.0 * s["scan_lanes"] / s["device_queries"]
