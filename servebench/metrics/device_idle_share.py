"""The device: 1 less the union of its operations' intervals over the traced
slice's wall time, in %."""


def read(ctx):
    w = ctx.trace["window_s"]
    return 100.0 * (1.0 - ctx.trace["busy_s"] / w) if w > 0 else None
