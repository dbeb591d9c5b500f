"""build.l2dist_qn_pct: seconds of ``ops.l2dist_qn`` in the build, by CUDA
events around each call, over ``build_s``."""


def read(ctx):
    if ctx.get("l2dist_s") is None:
        return None
    return 100.0 * ctx["l2dist_s"] / ctx["build_s"]
