"""Flash attention: the Hopper CUDA kernel's launcher and its plain version.

Causal (or full) self-attention in the reference's layout: q (B, Hq, S, D),
k/v (B, Hkv, T, D); GQA maps q head h to kv head h // (Hq / Hkv). Under
``causal`` query i of row b sees key j iff ``j <= q_offset[b] + i``: with
``q_offset`` zero and T == S that is the TPU kernel's causal mask, and with
``q_offset`` the rows' cache positions it is the reference's extend
attention (a chunk appended to each row's cache). Scores are scaled,
masked to -1e30, soft-maxed over T and contracted with v in f32; the result
is (B, Hq, S, D) in q's dtype, as the TPU kernel writes it.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` in the JAX package's ``kernels/flash_attention.py``.
``kernels.ops.flash_attention`` is the wrapper callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 96, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's masked softmax)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(torch.float32)) * scale
    if causal:
        off = (torch.zeros((b,), dtype=torch.int64, device=q.device) if q_offset is None
               else q_offset.to(torch.int64))
        rows = off[:, None] + torch.arange(s, device=q.device)            # (B, S)
        visible = torch.arange(t, device=q.device)[None, None, :] <= rows[:, :, None]
        logits = logits.masked_fill(~visible[:, None, None], -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))
    return o.reshape(b, hq, s, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launch function, built and loaded at first use."""
    fn = build.load("flash_attention").flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check_strided(name: str, t: torch.Tensor):
    """The kernel moves 16 bytes (8 bf16) at a time along D."""
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be unit-stride on D, with strides that are multiples "
                         f"of 8 and a 16-byte aligned base; got strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None,
                         q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on bf16 CUDA tensors; raises on anything it
    does not take. q, k and v are read in place through their strides; the
    result is a (B, Hq, S, D) view of a (B, S, Hq, D) buffer, so a caller
    in the model's (B, S, H, D) layout transposes it back without a copy."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("q_offset", q_offset)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected (B, Hq, S, D) and two (B, Hkv, T, D)")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv or d not in HEAD_DIMS or s < 1 or t < 1:
        raise ValueError(f"unsupported flash attention: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"(D must be one of {HEAD_DIMS}, Hq a multiple of Hkv)")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes bf16 q/k/v only, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, x)
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    if q_offset.dtype != torch.int32 or tuple(q_offset.shape) != (b,) \
            or not q_offset.is_contiguous():
        raise ValueError(f"q_offset must be a contiguous ({b},) int32 tensor")
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if b == 0:
        return out
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
                     out.data_ptr(), b, hq, hkv, s, t, d, int(causal), float(scale), strides,
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out
