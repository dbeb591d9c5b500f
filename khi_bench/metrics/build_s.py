"""build_s: the host clock around ``KHIIndex.build`` and
``device_put_index``, ending in a synchronize (set-up)."""


def read(ctx):
    return ctx["build_s"]
