"""service.outside_device_pct: the share of the window that the service
spent outside its planner's search, by its own counter
(``KHIService.snapshot()["device_seconds"]``, host time around each
micro-batch's search)."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    inside = ctx["snapshot"]["device_seconds"]
    return 100.0 * (1.0 - inside / ctx["window"]["seconds"])
