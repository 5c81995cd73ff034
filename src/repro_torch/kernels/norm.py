"""Row norms (RMSNorm, LayerNorm): the Hopper CUDA kernel's launcher and
its plain version.

``rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * scale``; ``layernorm``:
``(x - mu) * rsqrt(var + eps) * scale + bias`` with the variance taken
around the mean. Both in f32 over the last axis, the result in x's dtype:
the reference's ``models/layers.py`` ``norm_apply``, which is plain XLA
(there is no TPU kernel). The kernel is ``csrc/norm.cu``: it sums each row
in one order fixed by the width alone, where the plain version's eager
reduction picks its order from the number of rows. ``kernels.ops.norm`` is
the wrapper callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NORM_TYPES = ("rmsnorm", "layernorm")


def norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None,
               norm_type: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel (eager ops: on the card a row's
    sum is taken in an order that depends on the number of rows)."""
    xf = x.to(torch.float32)
    if norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * scale
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    lib = build.load("norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.norm_launch.argtypes = [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, p]
    lib.norm_launch.restype = ctypes.c_int
    return lib


def max_width(dtype: torch.dtype, d: int) -> int:
    """The widest row the kernel takes for rows of ``d`` elements of ``dtype``
    (16-byte columns where d allows them, else one element a column)."""
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    return 256 * 8 * (per if d % per == 0 else 1)


def norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None,
              norm_type: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on a bf16 or f32 CUDA tensor; raises on
    anything it does not take. Leading dims flatten to rows."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"norm_cuda needs CUDA tensors, got {dev}")
    if norm_type not in NORM_TYPES:
        raise ValueError(f"norm_type must be one of {NORM_TYPES}, got {norm_type!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or f32 rows, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= max_width(x.dtype, d):
        raise ValueError(f"unsupported norm width {d} for {x.dtype} "
                         f"(at most {max_width(x.dtype, d)})")
    params = [("scale", scale)] + ([("bias", bias)] if norm_type == "layernorm" else [])
    if norm_type == "layernorm" and bias is None:
        raise ValueError("layernorm needs a bias")
    for name, p in params:
        if p.device != dev or tuple(p.shape) != (d,):
            raise ValueError(f"{name} must be a ({d},) tensor on {dev}, got "
                             f"{tuple(p.shape)} on {p.device}")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous() if norm_type == "layernorm" else None
    x2 = x.reshape(-1, d).contiguous()
    if (d * x.element_size()) % 16 == 0 and x2.data_ptr() % 16:
        raise ValueError("the kernel loads 16 bytes at a time: x must be 16-byte aligned")
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    rc = _library().norm_launch(x2.data_ptr(), scale.data_ptr(),
                                None if bias is None else bias.data_ptr(), out.data_ptr(),
                                x2.shape[0], d, float(eps), int(x.dtype == torch.bfloat16),
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"norm kernel launch failed: CUDA error {rc}")
    return out.reshape(x.shape)
