"""``kernels/csrc/decode_attention.cu``: each live slot's keys and values up
to its position (and its query and output) at the HBM bandwidth, over the
kernel's device time in the traced slice, in %."""
from servebench import flops


def read(ctx):
    k = ctx.trace["kernels"].get("decode_attention")
    if ctx.peaks is None or not k or not ctx.slice_decodes:
        return None
    costs = [x for _, c in ctx.slice_decodes for x in flops.decode_attention_cost(ctx.cfg, c)]
    return 100.0 * flops.bound_s(costs, ctx.peaks) / k[1]
