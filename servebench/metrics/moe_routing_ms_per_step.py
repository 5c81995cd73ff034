"""``models/moe.py`` route, dispatch and combine: device time of their eager
ATen ops in the traced slice (``servebench/devtrace.py``), per engine step
of the slice, in ms."""


def read(ctx):
    routing = ctx.trace["routing_s"]
    if not routing or not ctx.slice_steps:
        return None
    return sum(routing.values()) / len(ctx.slice_steps) * 1e3
