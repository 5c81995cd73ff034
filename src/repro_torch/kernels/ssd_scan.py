"""Mamba-2 SSD scan: the Hopper CUDA kernel's launcher and its plain version.

Both run the sequential state-space recurrence of every (batch row, head)
over S steps, in the model's layout:

    state = state * exp(dt[t] * A) + (dt[t] * x[t]) (outer) B[t]    (P, N), f32
    y[t]  = state @ C[t] + D * x[t]                                  (P,)

x (Bt, S, H, P) bf16 or f32; dt (Bt, S, H) f32 (post-softplus); A and D f32
of shape (H,) or (Bt, H); B and C (Bt, S, G, N) in x's dtype, head h reading
group h // (H / G); an optional initial state (Bt, H, P, N) f32 (zeros when
absent). y comes back in x's dtype, the final state in f32; with
``final_state_out`` the final state is written into that tensor, which may
be the initial state itself (in place). The recurrence runs in order over S,
so the result does not depend on how the reference's TPU kernel chunks S.

The kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``ssd_scan_pallas`` in the JAX package's ``kernels/ssd_scan.py``.
``kernels.ops.ssd_scan`` (the reference's (BH, S, P) signature) and
``kernels.ops.ssd_decode`` (one token against the slot states) are the
wrappers callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_MAX_P = 64
_MAX_N = 128


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: torch.Tensor,
                   initial_state: torch.Tensor | None = None,
                   return_final_state: bool = False,
                   final_state_out: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel (the reference's recurrence)."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    Bh = B.to(torch.float32).repeat_interleave(h // g, dim=2)       # (Bt, S, H, N)
    Ch = C.to(torch.float32).repeat_interleave(h // g, dim=2)
    Af = A.to(torch.float32).expand(bt, h)
    Df = D.to(torch.float32).expand(bt, h)
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)                             # (Bt, H)
        state = state * decay[:, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]) + Df[:, :, None] * xf[:, t])
    y = torch.stack(ys, dim=1).to(x.dtype)
    if final_state_out is not None:
        final_state_out.copy_(state)
        state = final_state_out
    return (y, state) if return_final_state or final_state_out is not None else y


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launch function, built and loaded at first use."""
    fn = build.load("ssd_scan").ssd_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 9 + [i] * 6 + [ll] * 16 + [i, p]
    fn.restype = ctypes.c_int
    return fn


def _bh_strides(t: torch.Tensor, bt: int, h: int, name: str):
    """(batch, head) element strides of an (H,) or (Bt, H) per-head vector."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be f32, got {t.dtype}")
    if t.dim() == 1 and t.shape[0] == h:
        return 0, t.stride(0)
    if t.dim() == 2 and tuple(t.shape) == (bt, h):
        return t.stride(0), t.stride(1)
    raise ValueError(f"{name} {tuple(t.shape)} is neither ({h},) nor ({bt}, {h})")


def _check_state(t: torch.Tensor, shape, name: str):
    if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernel moves the state "
                         "in 16-byte vectors)")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, D: torch.Tensor,
                  initial_state: torch.Tensor | None = None,
                  return_final_state: bool = False,
                  final_state_out: torch.Tensor | None = None):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does not
    take. x, dt, B and C are read in place through their strides (the
    serving path hands in strided views of the conv output)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {dev}")
    named = (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D),
             ("initial_state", initial_state), ("final_state_out", final_state_out))
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)} do not agree")
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (bt, s, h) or tuple(B.shape[:2]) != (bt, s)
            or g < 1 or h % g):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(B.shape)} do not agree")
    if p > _MAX_P or n > _MAX_N or n % 4:
        raise ValueError(f"unsupported SSD scan: P={p} (at most {_MAX_P}), "
                         f"N={n} (at most {_MAX_N}, a multiple of 4)")
    if x.dtype not in (torch.bfloat16, torch.float32) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"x/B/C must share bf16 or f32, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32:
        raise ValueError(f"dt must be f32, got {dt.dtype}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("x, B and C must be unit-stride on their last axis")
    sa = _bh_strides(A, bt, h, "A")
    sd = _bh_strides(D, bt, h, "D")
    if initial_state is not None:
        _check_state(initial_state, (bt, h, p, n), "initial_state")
    fin = None
    if final_state_out is not None:
        _check_state(final_state_out, (bt, h, p, n), "final_state_out")
        fin = final_state_out
    elif return_final_state:
        fin = torch.empty((bt, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty((bt, s, h, p), dtype=x.dtype, device=dev)
    if bt * h:
        fn = _launcher()
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                D.data_ptr(), initial_state.data_ptr() if initial_state is not None else None,
                fin.data_ptr() if fin is not None else None, y.data_ptr(),
                bt, s, h, p, g, n,
                x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
                B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1), C.stride(2),
                *sa, *sd, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    return (y, fin) if fin is not None else y
