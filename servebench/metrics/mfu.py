"""The model step (``models/transformer.py``, ``models/moe.py``): model FLOPs of
every prompt and output token the window processed (``servebench/flops.py``),
over the window's length at the card's bf16 dense peak, in %."""
from servebench import flops


def read(ctx):
    if ctx.peaks is None:
        return None
    work = (sum(flops.decode_flops(ctx.cfg, c) for _, c in ctx.decodes)
            + sum(flops.chunk_flops(ctx.cfg, p0, n) for _, p0, n, _ in ctx.chunks))
    w = ctx.window.t_end - ctx.window.t_open
    return 100.0 * work / (w * ctx.peaks["bf16_flops"]) if work else None
