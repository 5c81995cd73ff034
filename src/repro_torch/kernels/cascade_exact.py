"""The bit-accurate CASCADE matmul (FP5 products, FP8 column sums in order
over K): the Hopper CUDA kernel's launcher and its plain version.

x4 (M, K) and w4 (K, N) FP4-valued f32 (the ``precision_sim`` path of
``core/cascade.py`` rounds them onto the grid), an optional (N,) f32 bias
preloaded into the sums; out (M, N) f32. The plain version is
``core/quant.py``'s :func:`~repro_torch.core.quant.cascade_matmul_exact`;
the kernel is ``csrc/cascade_exact.cu`` (no TPU kernel: the reference's
oracle is an XLA loop), launched as :func:`plan` says.
``kernels.ops.cascade_matmul_exact`` is the wrapper callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import cascade_matmul_exact as cascade_matmul_exact_plain
from repro_torch.kernels import build

__all__ = ["cascade_matmul_exact_plain", "cascade_matmul_exact_cuda", "plan", "chain_cycles"]

#: columns a block (one a lane), and the most row groups (warps) a block
COLS, MAX_WARPS = 32, 8


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("cascade_exact")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_exact_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.cascade_exact_launch.restype = ctypes.c_int
    lib.cascade_exact_chain_launch.argtypes = [p, p, p, p, i, i, p]
    lib.cascade_exact_chain_launch.restype = ctypes.c_int
    return lib


def plan(m: int, n: int) -> dict:
    """The kernel's launch geometry for an (m, K) x (K, n) call: a thread
    owns one column and ``rows`` consecutive rows (independent chains in one
    thread), a warp 32 columns of those rows, a block ``warps`` row groups
    over the same 32 columns. Up to 32 rows sit in one block, so w is
    staged once for all of them: 1 row a thread up to M = 8, 2 up to 16, 4
    up to 32. Past 32 rows a thread takes 8 rows and a block 4 warps (32
    rows), so a column strip's blocks stay small enough to spread over the
    card."""
    if m < 1 or n < 1:
        raise ValueError(f"cascade_exact plan: m={m} n={n}")
    rows = 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8
    warps = min(-(-m // rows), MAX_WARPS if rows < 8 else 4)
    bm = rows * warps
    return {"rows": rows, "warps": warps, "block_rows": bm, "threads": 32 * warps,
            "grid": (-(-n // COLS), -(-m // bm))}


def chain_cycles(steps: int, device, add: bool = False) -> dict:
    """One thread walks ``steps`` dependent steps of the kernel's chain (FP4
    operands from registers), or with ``add`` ``steps`` dependent plain f32
    adds: the SM clock cycles they took, timed inside the kernel with
    ``clock64``, and the device ms of the launch between CUDA events. Their
    ratio to ``steps`` is one step's latency, or one add's."""
    x = torch.tensor([1.5, -3.0, 0.5, 6.0], dtype=torch.float32, device=device)
    w = torch.tensor([1.5, 2.0, -1.0, 0.5], dtype=torch.float32, device=device)
    out = torch.empty(1, dtype=torch.float32, device=device)
    cyc = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device)
    lib = _library()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):                           # the first call loads the module
        t0.record(stream)
        rc = lib.cascade_exact_chain_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                            cyc.data_ptr(), steps, int(add),
                                            stream.cuda_stream)
        t1.record(stream)
        if rc != 0:
            raise RuntimeError(f"cascade_exact chain probe launch failed: CUDA error {rc}")
    t1.synchronize()
    return {"steps": steps, "cycles": int(cyc.item()), "ms": t0.elapsed_time(t1),
            "sum": float(out.item())}


def cascade_matmul_exact_cuda(x4: torch.Tensor, w4: torch.Tensor,
                              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: x4 (M, K), w4 (K, N), bias (N,) or None, f32 CUDA
    tensors (made contiguous here); raises on anything it does not take."""
    dev = x4.device
    if dev.type != "cuda":
        raise ValueError(f"the exact CASCADE kernel needs CUDA tensors, got {dev}")
    for name, t in (("x4", x4), ("w4", w4), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev):
            raise ValueError(f"{name} must be f32 on {dev}, got {t.dtype} on {t.device}")
    if x4.dim() != 2 or w4.dim() != 2 or x4.shape[1] != w4.shape[0] \
            or (bias is not None and bias.shape != (w4.shape[1],)):
        raise ValueError(f"shapes: x4 (M, K), w4 (K, N), bias (N,); got {tuple(x4.shape)}, "
                         f"{tuple(w4.shape)}, {None if bias is None else tuple(bias.shape)}")
    m, k = x4.shape
    n = w4.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        xc, wc = x4.contiguous(), w4.contiguous()
        bc = bias.contiguous() if bias is not None else None
        pl = plan(m, n)
        rc = _library().cascade_exact_launch(
            xc.data_ptr(), wc.data_ptr(), None if bc is None else bc.data_ptr(), out.data_ptr(),
            m, k, n, pl["rows"], pl["warps"], torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cascade_matmul_exact kernel launch failed: CUDA error {rc}")
    return out
