"""Row norms (RMSNorm, LayerNorm), alone or fused with the step before
them: the Hopper CUDA kernel's launchers and their plain versions.

``rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * scale``; ``layernorm``:
``(x - mu) * rsqrt(var + eps) * scale + bias`` with the variance taken
around the mean. Both in f32 over the last axis, the result in x's dtype:
the reference's ``models/layers.py`` ``norm_apply``, which is plain XLA
(there is no TPU kernel). Two fused forms take the eager step before a norm
into the same launch:

* add-norm: ``s = x + r`` (rounded to x's dtype), then the norm of ``s``;
  returns both (the residual add before a transformer or Mamba-2 layer's
  norm, ``s`` the new residual stream);
* gated norm: the RMSNorm of ``(y * silu(z.f32)).to(y.dtype)`` (Mamba-2's
  gate before its gated norm); ``z`` may be a column slice read through its row
  stride, read one element a load where its offset or row stride breaks the
  kernel's wide load (the same bits).

The kernel is ``csrc/norm.cu``: it sums each row in one order fixed by the
width alone, where the plain versions' eager reduction picks its order from
the number of rows. ``kernels.ops.norm``/``add_norm``/``gated_norm`` are
the wrappers callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

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


def add_norm_plain(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None = None, norm_type: str = "rmsnorm",
                   eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the add-norm form: (norm(x + r), x + r)."""
    s = x + r
    return norm_plain(s, scale, bias, norm_type, eps), s


def gated_norm_plain(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the gated form: rmsnorm((y * silu(z.f32)).to(y.dtype))."""
    return norm_plain((y * F.silu(z.to(torch.float32))).to(y.dtype), scale, None, "rmsnorm", eps)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    lib = build.load("norm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.norm_launch.argtypes = [p, ll, p, ll, p, ll, i, i, p, p, p, p, ll, i, ctypes.c_float, i,
                                p]
    lib.norm_launch.restype = ctypes.c_int
    return lib


def max_width(dtype: torch.dtype, d: int) -> int:
    """The widest row the kernel takes for rows of ``d`` elements of ``dtype``
    (16-byte columns where d allows them, else one element a column)."""
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    return 256 * 8 * (per if d % per == 0 else 1)


def _rows(name: str, t: torch.Tensor, d: int, vec: int, strict: bool = True):
    """``t``'s rows for the kernel: (the tensor, its row stride, whether the
    kernel can load ``vec`` elements at once). A contiguous ``t`` is passed
    as it is; else a (rows, d) view where the leading dims merge and the
    last is unit-stride (a column slice stays a view), or a contiguous copy.
    The load is 16 bytes of x's dtype, or 1 element, and at most 16 bytes of
    ``t``'s: with ``strict``, rows that do not start aligned to it raise;
    else the kernel reads them one element at a time (the same arithmetic,
    the same bits)."""
    if t.is_contiguous():
        stride = d
    else:
        t = t.reshape(-1, d)
        if d > 1 and t.stride(1) != 1:
            t = t.contiguous()
        stride = t.stride(0) if t.shape[0] > 1 else d
    size = t.element_size()
    align = min(16, vec * size)
    wide = vec > 1 and not (t.data_ptr() % align or (stride * size) % align)
    if strict and vec > 1 and not wide:
        raise ValueError(f"the kernel loads 16 bytes of {name} at a time: its rows must start "
                         f"16-byte aligned (offset and row stride)")
    return t, stride, wide


def _launch(x: torch.Tensor, r: torch.Tensor | None, z: torch.Tensor | None,
            scale: torch.Tensor, bias: torch.Tensor | None, norm_type: str, eps: float):
    """Check the inputs and launch one form; returns (out, sum or None) in
    x's shape. Written for host time: the served step calls it 65-97 times."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the norm kernel needs CUDA tensors, got {dev}")
    if norm_type not in NORM_TYPES:
        raise ValueError(f"norm_type must be one of {NORM_TYPES}, got {norm_type!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or f32 rows, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= max_width(x.dtype, d):
        raise ValueError(f"unsupported norm width {d} for {x.dtype} "
                         f"(at most {max_width(x.dtype, d)})")
    if r is not None and (r.device != dev or r.dtype != x.dtype or r.shape != x.shape):
        raise ValueError(f"r must match x's dtype, shape and device ({x.dtype}, "
                         f"{tuple(x.shape)}, {dev}), got {r.dtype}, {tuple(r.shape)}, {r.device}")
    if z is not None and (z.device != dev or z.dtype not in (torch.bfloat16, torch.float32)
                          or z.shape != x.shape):
        raise ValueError(f"z must be bf16 or f32 (either with bf16 or f32 y) of y's shape and "
                         f"device ({tuple(x.shape)}, {dev}), got {z.dtype}, {tuple(z.shape)}, "
                         f"{z.device}")
    layer = norm_type == "layernorm"
    if layer and bias is None:
        raise ValueError("layernorm needs a bias")
    for name, p in (("scale", scale), ("bias", bias if layer else None)):
        if p is not None and (p.device != dev or p.shape != (d,)):
            raise ValueError(f"{name} must be a ({d},) tensor on {dev}, got "
                             f"{tuple(p.shape)} on {p.device}")
    if scale.dtype is not torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous() if layer else None
    per = 16 // x.element_size()
    vec = per if d % per == 0 else 1
    x2, xs, _ = _rows("x", x, d, vec)
    r2, rs, _ = _rows("r", r, d, vec) if r is not None else (None, 0, True)
    z2, zs, zwide = _rows("z", z, d, vec, strict=False) if z is not None else (None, 0, True)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    s = torch.empty_like(out) if r is not None else None
    rows = x.numel() // d
    if rows:
        rc = _library().norm_launch(
            x2.data_ptr(), xs, None if r2 is None else r2.data_ptr(), rs,
            None if z2 is None else z2.data_ptr(), zs,
            int(z is not None and z.dtype == torch.bfloat16), int(zwide), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if s is None else s.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"norm kernel launch failed: CUDA error {rc}")
    return out, s


def norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None,
              norm_type: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """Launch the norm form on a bf16 or f32 CUDA tensor; raises on anything
    it does not take. Leading dims flatten to rows."""
    return _launch(x, None, None, scale, bias, norm_type, eps)[0]


def add_norm_cuda(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor | None = None, norm_type: str = "rmsnorm",
                  eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the add-norm form: (norm(x + r), x + r), x and r of one dtype
    and shape; raises on anything it does not take."""
    return _launch(x, r, None, scale, bias, norm_type, eps)


def gated_norm_cuda(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Launch the gated form: rmsnorm((y * silu(z.f32)).to(y.dtype)), y and z
    of one shape, each bf16 or f32 (Mamba-2's dual form gives f32 y beside
    bf16 z), z read through its row stride; raises on anything it does not
    take."""
    return _launch(y, None, z, scale, None, "rmsnorm", eps)[0]
