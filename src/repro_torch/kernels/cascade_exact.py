"""The bit-accurate CASCADE matmul (FP5 products, FP8 column sums in order
over K): the Hopper CUDA kernel's launcher and its plain version.

x4 (M, K) and w4 (K, N) FP4-valued f32 (the ``precision_sim`` path of
``core/cascade.py`` rounds them onto the grid), an optional (N,) f32 bias
preloaded into the sums; out (M, N) f32. The plain version is
``core/quant.py``'s :func:`~repro_torch.core.quant.cascade_matmul_exact`;
the kernel is ``csrc/cascade_exact.cu`` (no TPU kernel: the reference's
oracle is an XLA loop). ``kernels.ops.cascade_matmul_exact`` is the wrapper
callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import cascade_matmul_exact as cascade_matmul_exact_plain
from repro_torch.kernels import build

__all__ = ["cascade_matmul_exact_plain", "cascade_matmul_exact_cuda"]


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("cascade_exact")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_exact_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.cascade_exact_launch.restype = ctypes.c_int
    return lib


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
        rc = _library().cascade_exact_launch(
            xc.data_ptr(), wc.data_ptr(), None if bc is None else bc.data_ptr(), out.data_ptr(),
            m, k, n, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cascade_matmul_exact kernel launch failed: CUDA error {rc}")
    return out
