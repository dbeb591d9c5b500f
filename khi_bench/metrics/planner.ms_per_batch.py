"""planner.ms_per_batch: mean ms of a ``Planner.plan`` call (span
``planner.plan``)."""


def read(ctx):
    spans = ctx.get("spans")
    if spans is None:
        return None
    seconds, calls, _ = spans.total("planner.plan")
    return 1e3 * seconds / calls if calls else None
