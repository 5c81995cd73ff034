"""``kernels/csrc/cascade_matmul_grouped.cu``: the least time of the routed
experts' launches in the traced slice (their weights, their rows in and
out, at the rows each step and chunk routes), over the kernel's device
time there, in %."""
from servebench import flops
from servebench.families import moe


def read(ctx):
    k = ctx.trace["kernels"].get("cascade_matmul_grouped")
    if ctx.peaks is None or not k:
        return None
    costs = [x for _, c in ctx.slice_decodes for x in moe.grouped_matmul_cost(ctx.cfg, len(c))]
    costs += [x for _, _, n, _ in ctx.slice_chunks
              for x in moe.grouped_matmul_cost(ctx.cfg, n)]
    return 100.0 * flops.bound_s(costs, ctx.peaks) / k[1]
