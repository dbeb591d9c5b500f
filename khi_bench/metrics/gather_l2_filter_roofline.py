"""gather_l2_filter_roofline: the least time the card could take for the
window's ``gather_l2_filter`` calls (kernel-table row 1's bytes and
operations, counted per call by ``trace.GatherCounter``, against the
H100's peaks) over the profiler's time of the kernel. Where the profiler
recorded fewer launches than were made, the bound is taken over the
recorded share of the calls."""

from khi_bench import cost


def read(ctx):
    g, rec = ctx.get("gather"), ctx.get("device_record")
    if not g or not g["calls"] or rec is None:
        return None
    seconds, records = rec.kernel(r"gather_l2_filter_kernel")
    if not records or seconds <= 0:
        return None
    bound, _ = cost.bound_s(g["bytes"], g["ops"])
    return 100.0 * bound * min(1.0, records / g["calls"]) / seconds
