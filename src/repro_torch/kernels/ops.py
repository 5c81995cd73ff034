"""Public wrappers for the port's kernels: padding, reshapes and dispatch.

A tensor on the CPU goes to the kernel's plain version; a CUDA tensor goes
to the CUDA kernel, which launches or raises. There is no fallback from one
to the other. Every kernel launch adds one to ``LAUNCHES[name]``, so a run
can show that its path went through the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cascade_matmul as _cm
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import norm as _norm
from repro_torch.kernels import ssd_scan as _ssd

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"cascade_matmul": 0, "decode_attention": 0, "flash_attention": 0, "norm": 0,
            "ssd_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for a tensor on {t.device}")


def cascade_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                   bias: torch.Tensor | None = None, *,
                   out_dtype=torch.float32) -> torch.Tensor:
    """FP4-packed weight matmul: x (.., K) @ Wq (K, N) (+ bias) -> (.., N).

    Leading dims of x flatten to M. Odd-K weights carry ``quantize_weight``'s
    zero pad row; the activations get a matching zero column."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = packed.shape[1]
    x2 = x.reshape(-1, k)
    if packed.shape[0] * 2 == k + 1:
        x2 = F.pad(x2, (0, 1))
    if _route(x2) == "cuda":
        out = _cm.cascade_matmul_cuda(x2.contiguous(), packed, scales, bias, out_dtype)
        LAUNCHES["cascade_matmul"] += 1
    else:
        out = _cm.cascade_matmul_plain(x2, packed, scales, bias, out_dtype)
    return out.reshape(*lead, n)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor | None = None, *, scale: float | None = None,
                     q_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Decode-step attention on a stacked cache. q: (B, Hq, D), one query
    token per slot; k/v: (B, T, Hkv, D) cache buffers. Key t of row b is
    live iff ``t <= q_pos[b]`` (q_pos: (B,) int32, the row's position; the
    kernel then reads no row past it) and ``valid[b, t]`` is nonzero; either
    may be absent. Returns (B, Hq, D) f32."""
    if _route(q) == "cuda":
        out = _da.decode_attention_cuda(q.contiguous(), k, v, valid, scale, q_pos)
        LAUNCHES["decode_attention"] += 1
        return out
    return _da.decode_attention_plain(q, k, v, valid, scale, q_pos)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: float | None = None,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked self-attention, GQA-aware. q: (B, Hq, S, D); k/v: (B, Hkv,
    T, D). Causal: query i of row b sees key j iff ``j <= q_offset[b] + i``
    (q_offset: (B,) int32, zeros when absent, so with T == S the plain
    causal mask). Returns (B, Hq, S, D) in q's dtype. The CUDA kernel takes
    bf16 only and reads q/k/v through their strides, so k/v may be a
    cache's live prefix (its launch plan follows T)."""
    if _route(q) == "cuda":
        out = _fa.flash_attention_cuda(q, k, v, causal, scale, q_offset)
        LAUNCHES["flash_attention"] += 1
        return out
    return _fa.flash_attention_plain(q, k, v, causal, scale, q_offset)


def norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None, *,
         norm_type: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis in f32, out in x's dtype. The
    CUDA kernel sums each row in one order fixed by the width, so a row
    rounds alike whatever the number of rows in the call."""
    if _route(x) == "cuda":
        out = _norm.norm_cuda(x, scale, bias, norm_type, eps)
        LAUNCHES["norm"] += 1
        return out
    return _norm.norm_plain(x, scale, bias, norm_type, eps)


def add_norm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None = None, *, norm_type: str = "rmsnorm",
             eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: ``(norm(x + r), x + r)``, the
    sum rounded to x's dtype as eager ``x + r`` rounds it. One launch of the
    norm kernel on the card (counted under ``LAUNCHES["norm"]``)."""
    if _route(x) == "cuda":
        out = _norm.add_norm_cuda(x, r, scale, bias, norm_type, eps)
        LAUNCHES["norm"] += 1
        return out
    return _norm.add_norm_plain(x, r, scale, bias, norm_type, eps)


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gate and the RMSNorm after it: ``rmsnorm((y * silu(z.f32))
    .to(y.dtype))``. z may be a column slice (the kernel reads it through
    its row stride). One launch of the norm kernel on the card (counted
    under ``LAUNCHES["norm"]``)."""
    if _route(y) == "cuda":
        out = _norm.gated_norm_cuda(y, z, scale, eps)
        LAUNCHES["norm"] += 1
        return out
    return _norm.gated_norm_plain(y, z, scale, eps)


def _ssd_scan(x, dt, A, B, C, D, initial_state, return_final_state, final_state_out=None):
    if _route(x) == "cuda":
        out = _ssd.ssd_scan_cuda(x, dt, A, B, C, D, initial_state, return_final_state,
                                 final_state_out)
        LAUNCHES["ssd_scan"] += 1
        return out
    return _ssd.ssd_scan_plain(x, dt, A, B, C, D, initial_state, return_final_state,
                               final_state_out)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, *, initial_state: torch.Tensor | None = None,
             return_final_state: bool = False):
    """Per-head SSD recurrence in the reference's ``ssd_scan_pallas`` layout
    (inputs broadcast per head): x (BH, S, P); dt (BH, S) f32; A, D (BH,)
    f32; B, C (BH, S, N); optional initial state (BH, P, N) f32. Returns y
    (BH, S, P) in x's dtype, and the final state (BH, P, N) f32 with
    ``return_final_state``. The recurrence runs in order over S, so the TPU
    kernel's ``chunk`` tiling has no counterpart here."""
    init = initial_state[:, None] if initial_state is not None else None
    out = _ssd_scan(x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None], C[:, :, None],
                    D[:, None], init, return_final_state)
    if return_final_state:
        y, fin = out
        return y[:, :, 0], fin[:, 0]
    return out[:, :, 0]


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor, state: torch.Tensor, *,
               out_state: torch.Tensor | None = None):
    """One-token SSD recurrence on the stacked decode cache, in the shapes of
    ``models.ssm.ssd_decode_step``: x (B, 1, H, P); dt (B, 1, H) f32; A, D
    (H,) f32; B, C (B, 1, G, N); state (B, H, P, N) f32. Returns (y (B, 1,
    H, P) in x's dtype, new state f32). With ``out_state`` the new state is
    written there (it may be ``state`` itself: the slot states are updated
    in place) and that tensor is returned."""
    return _ssd_scan(x, dt, A, B, C, D, state, True, out_state)
