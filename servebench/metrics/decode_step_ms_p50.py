"""``serve/engine.py`` batched decode: the median of ``ServeEngine.step_times``
over the window's steps that decoded (the host clock around the decode part
of a step, which ends in the step's one read to the host), in ms."""
import numpy as np


def read(ctx):
    parts = [part for _, _, part, _ in ctx.window.steps if part > 0]
    return float(np.median(parts)) * 1e3 if parts else None
