"""graph.ms_per_lane: ms of the graph program (span ``graph.program``,
``Planner._run_graph``) over the lanes it was handed, pads included."""


def read(ctx):
    spans = ctx.get("spans")
    if spans is None:
        return None
    seconds, _, lanes = spans.total("graph.program")
    return 1e3 * seconds / lanes if lanes else None
