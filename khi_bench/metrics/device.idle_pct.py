"""device.idle_pct: the share of the traced window in which no operation
of the program ran on the card (profiler records, the benchmark's own
stream left out)."""


def read(ctx):
    rec = ctx.get("device_record")
    if rec is None or not rec.ops:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
