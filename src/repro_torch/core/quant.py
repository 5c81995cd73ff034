"""FP4 E2M1 codec and post-training quantization, in PyTorch.

The integer work here (codes, nibble packing, quantized matrices) matches
the JAX package's ``core/quant.py`` bit for bit:

* FP4 E2M1 values +/-{0, .5, 1, 1.5, 2, 3, 4, 6}, round to nearest with
  ties to the even code, saturating at 6 (+/-inf too). E2M1 has no NaN:
  a NaN of either sign rounds to -0 (code 8), as the reference's native
  ``float4_e2m1fn`` cast does, and encodes by its own sign bit (+NaN to
  code 0, -NaN to code 8).
* Two codes per uint8 along the contraction dim, low nibble = even row.
* Absmax group quantization of (K, N) weights into packed codes + (G, N)
  f32 scales, with a zero pad row for odd K.

The FP5/FP8 CASCADE oracles and QAT fake-quant are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: Values of the 8 non-negative FP4 E2M1 codes (code = s<<3 | e<<1 | m).
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_MAX = 6.0
#: Midpoints between adjacent positive values (all exact in f32).
_FP4_MIDPOINTS = tuple((a + b) / 2.0 for a, b in zip(FP4_VALUES[1:], FP4_VALUES[:-1]))


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def fp4_round(x: torch.Tensor) -> torch.Tensor:
    """Round values onto the FP4 E2M1 grid (RNE, saturating, NaN to -0); f32 out."""
    xf = x.to(torch.float32)
    mag = xf.abs()
    mid = _table(_FP4_MIDPOINTS, xf)
    lo = torch.searchsorted(mid, mag, out_int32=True, right=False)   # ties -> lower value index
    hi = torch.searchsorted(mid, mag, out_int32=True, right=True)    # ties -> upper value index
    idx = torch.where(lo % 2 == 0, lo, hi)           # tie: pick even mantissa code
    mag4 = _table(FP4_VALUES, xf)[idx.clamp(max=7)]
    out = torch.where(torch.signbit(xf), -mag4, mag4)
    return torch.where(torch.isnan(xf), torch.full_like(xf, -0.0), out)


def fp4_encode(x: torch.Tensor) -> torch.Tensor:
    """Encode float -> FP4 E2M1 code (uint8 in 0..15), round-to-nearest-even."""
    v = fp4_round(x)
    sign = (v < 0) | ((v == 0) & torch.signbit(x.to(torch.float32)))
    code = torch.searchsorted(_table(FP4_VALUES, v), v.abs(), out_int32=True,
                            right=False).to(torch.uint8)
    return torch.where(sign, code + 8, code).to(torch.uint8)


def fp4_decode(code: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Decode FP4 E2M1 code (uint8 0..15) -> float, arithmetically:
    value = (-1)^s * (e == 0 ? 0.5*m : (1 + 0.5*m) * 2^(e-1))."""
    c = code.to(torch.int32)
    s = (c >> 3) & 1
    e = (c >> 1) & 3
    mf = (c & 1).to(torch.float32)
    normal = (1.0 + 0.5 * mf) * torch.exp2(e.to(torch.float32) - 1.0)
    mag = torch.where(e == 0, 0.5 * mf, normal)
    return torch.where(s == 1, -mag, mag).to(dtype)


def pack_fp4(codes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack pairs of 4-bit codes along ``axis`` into uint8 (low nibble first)."""
    c = codes.movedim(axis, 0)
    if c.shape[0] % 2:
        raise ValueError("packing axis must be even")
    lo = c[0::2].to(torch.uint8)
    hi = c[1::2].to(torch.uint8)
    return (lo | (hi << 4)).movedim(0, axis).contiguous()


def unpack_fp4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_fp4`."""
    p = packed.movedim(axis, 0)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = torch.stack([lo, hi], dim=1).reshape((p.shape[0] * 2,) + tuple(p.shape[1:]))
    return out.movedim(0, axis)


def quantize_weight(w: torch.Tensor, group_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (K, N) weight matrix to packed FP4 codes + scales.

    group_size: contraction-dim group for scales; 0 => one scale per output
    column. Scales map the group absmax to FP4_MAX. Odd K gets one all-zero
    pad row first (code 0, decodes to exactly 0); only with group_size=0.

    Returns packed (ceil(K/2), N) uint8 (low nibble = even row) and
    scales (G, N) f32.
    """
    k, n = w.shape
    w = w.to(torch.float32)
    if k % 2:
        if group_size != 0:
            raise ValueError("odd K needs per-column scales (group_size=0)")
        w = torch.cat([w, w.new_zeros((1, n))], dim=0)
        k += 1
    g = group_size if group_size > 0 else k
    if k % g:
        raise ValueError(f"K={k} not divisible by group_size={g}")
    wg = w.reshape(k // g, g, n)
    absmax = wg.abs().amax(dim=1)                              # (G, N)
    scales = torch.where(absmax > 0, absmax / FP4_MAX, torch.ones_like(absmax))
    codes = fp4_encode(wg / scales[:, None, :]).reshape(k, n)
    return pack_fp4(codes, axis=0), scales


def dequantize_weight(packed: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` -> (K, N) dense weights (an odd-K
    original keeps its zero pad row)."""
    codes = unpack_fp4(packed, axis=0)
    k, n = codes.shape
    g = k // scales.shape[0]
    vals = fp4_decode(codes, torch.float32).reshape(k // g, g, n)
    return (vals * scales[:, None, :]).reshape(k, n).to(dtype)
