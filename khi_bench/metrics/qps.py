"""qps: queries answered in the window over the window's seconds."""


def read(ctx):
    w = ctx["window"]
    return w["answered"] / w["seconds"]
