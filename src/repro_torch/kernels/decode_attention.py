"""Decode attention: the Hopper CUDA kernel's launcher and its plain version.

One query token per slot against one layer's stacked cache: q (B, Hq, D),
k/v (B, T, Hkv, D), a (B, T) validity mask; GQA maps q head h to kv head
h // (Hq / Hkv). Scores are scaled, masked to -1e30, soft-maxed over T and
contracted with v, all in f32; the result is (B, Hq, D) f32. The kernel is
``csrc/decode_attention.cu``; it replaces the TPU kernel
``decode_attention_pallas`` in the JAX package's
``kernels/flash_attention.py``. ``kernels.ops.decode_attention`` is the
wrapper callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_MAX_D = 256


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's masked softmax)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qd = q.to(torch.float32).reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qd, k.to(torch.float32)) * scale
    logits = logits.masked_fill(~(mask != 0)[:, None, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return o.reshape(b, hq, d)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launch function, built and loaded at first use."""
    fn = build.load("decode_attention").decode_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                   ll, ll, ll, ll, ll, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel; k/v are read in place through their strides."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if hq % hkv or d > _MAX_D or t < 1 or tuple(mask.shape) != (b, t):
        raise ValueError(f"unsupported decode attention: Hq={hq} Hkv={hkv} D={d} T={t} "
                         f"mask {tuple(mask.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q must be contiguous and k/v unit-stride on D")
    live = (mask if mask.dtype == torch.bool else mask != 0).contiguous().view(torch.uint8)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    fn = _launcher()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), live.data_ptr(), out.data_ptr(),
            b, hq, hkv, t, d, float(scale), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    return out
