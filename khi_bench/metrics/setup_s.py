"""setup_s: from the start of the process to the start of the window:
kernels (built once a checkout), data, the build, the service, warm-up."""


def read(ctx):
    return ctx["setup_s"]
