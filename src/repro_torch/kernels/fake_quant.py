"""FP4 fake quantization for QAT: the Hopper CUDA kernel's launcher and its
plain version.

``w + (qdq(w) - f32(w)).to(w.dtype)`` with ``qdq`` the absmax FP4 round
trip of each (group, column) of a (K, N) weight (``core/quant.py``,
:func:`~repro_torch.core.quant.fake_quant_fp4_plain`, is the plain version).
A weight of more dims is one (-1, N) matrix, or, with ``experts``, a
(E, K, N) stack of E matrices with scales of their own. The kernel is
``csrc/fake_quant.cu``; there is no TPU kernel (the reference's
``fake_quant_fp4`` is plain XLA). ``kernels.ops.fake_quant_fp4`` is the
wrapper callers use: it adds the straight-through gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import fake_quant_fp4_plain, fake_quant_groups
from repro_torch.kernels import build

__all__ = ["fake_quant_fp4_plain", "fake_quant_fp4_cuda", "strip_width"]

#: the H100's SMs: the strip width is cut until the grid covers them twice
_SMS = 132


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("fake_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fake_quant_fp4_launch.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.fake_quant_fp4_launch.restype = ctypes.c_int
    return lib


def strip_width(b: int, k: int, n: int, g: int) -> int:
    """Columns a block owns: 32 (a warp's coalesced row strip) unless the
    grid would then hold fewer than two blocks an SM, then 16 or 8."""
    for cols in (32, 16):
        if -(-n // cols) * (k // g) * b >= 2 * _SMS:
            return cols
    return 8


def fake_quant_fp4_cuda(w: torch.Tensor, group_size: int = 0,
                        experts: bool = False) -> torch.Tensor:
    """Launch the kernel on a bf16 or f32 CUDA weight; raises on anything it
    does not take. Returns a new tensor of w's shape and dtype."""
    if w.device.type != "cuda":
        raise ValueError(f"the fake-quant kernel needs a CUDA tensor, got {w.device}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the fake-quant kernel takes bf16 or f32 weights, got {w.dtype}")
    if w.dim() < 2 or (experts and w.dim() != 3):
        raise ValueError(f"fake quantization takes a (K, N) weight, or a (E, K, N) expert "
                         f"stack with experts=True; got shape {tuple(w.shape)}")
    n = w.shape[-1]
    b = w.shape[0] if experts else 1
    k = w.numel() // (n * b)
    g = fake_quant_groups(k, group_size)
    wc = w.contiguous()
    out = torch.empty_like(wc)
    if w.numel():
        rc = _library().fake_quant_fp4_launch(
            wc.data_ptr(), out.data_ptr(), b, k, n, g, strip_width(b, k, n, g),
            int(w.dtype == torch.bfloat16), torch.cuda.current_stream(w.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fake_quant_fp4 kernel launch failed: CUDA error {rc}")
    return out
