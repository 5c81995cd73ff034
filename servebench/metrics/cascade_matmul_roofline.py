"""``kernels/csrc/cascade_matmul.cu``: the least time of the FP4 linears'
launches in the traced slice (decode steps at their live rows, admission
chunks at their valid rows and the head on one), over the kernel's device
time there, in %."""
from servebench import flops


def read(ctx):
    k = ctx.trace["kernels"].get("cascade_matmul")
    if ctx.peaks is None or not k:
        return None
    costs = []
    for _, c in ctx.slice_decodes:
        costs += flops.cascade_matmul_costs(ctx.cfg, len(c), len(c))
    for _, _, n, _ in ctx.slice_chunks:
        costs += flops.cascade_matmul_costs(ctx.cfg, n, 1)
    return 100.0 * flops.bound_s(costs, ctx.peaks) / k[1]
