"""The inter-token gap's 95th percentile where it cannot stand as an
end-to-end metric, where the host paces the step (olmoe, the card idle most
of the slice). Every gap between consecutive tokens of a stream, both
committed inside the window (``harness.in_window_gaps``), in ms."""
import numpy as np

from servebench.harness import in_window_gaps


def read(ctx):
    gaps = in_window_gaps(ctx.window)
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
