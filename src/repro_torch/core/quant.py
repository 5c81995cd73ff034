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
* The bit-accurate CASCADE oracles (paper Sections 10.4-10.6): FP5 E3M1
  products (a 1-bit mantissa truncation of the f32 product) summed down a
  column in FP8 E4M3, saturating at +/-448 and truncating, in order over K.
  Integer work on an f32 carrier, bit for bit the reference's, NaN and
  +/-inf included: a NaN passes the saturation as ``jnp.clip`` passes it,
  and a NaN whose payload lies below the kept mantissa bits masks to +/-inf.
  :func:`cascade_matmul_exact` computes product k's (..., N) slice inside
  its loop over K (the reference builds all K at once), so the plain version
  also runs at a full model's widths; its CUDA kernel is
  ``kernels/csrc/cascade_exact.cu`` (``kernels.ops.cascade_matmul_exact``).
* QAT fake quantization with a straight-through gradient (paper Section
  4): :func:`fake_quant_fp4`, ``w + (qdq(w) - f32(w)).to(w.dtype)`` in w's
  dtype (at bf16 not the same bits as ``qdq(w)``), whose kernel is
  ``kernels/csrc/fake_quant.cu`` (``kernels.ops.fake_quant_fp4``), and
  :func:`fake_quant_fp8_e4m3`.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: Values of the 8 non-negative FP4 E2M1 codes (code = s<<3 | e<<1 | m).
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_MAX = 6.0
#: Midpoints between adjacent positive values (all exact in f32).
_FP4_MIDPOINTS = tuple((a + b) / 2.0 for a, b in zip(FP4_VALUES[1:], FP4_VALUES[:-1]))
#: Elements of a (K, N) matrix the elementwise codec takes at once: a larger
#: one (llama3.1-405b's 16384 x 128000 head) goes by blocks of columns, each
#: quantized or decoded on its own as every column is anyway (the same
#: bits), so the codec's f32 and int32 transients stay near 1 GB each. The
#: encode holds about eight such transients at once, so quantization takes
#: blocks an eighth that size (a mesh rank's init peak is one head's draw
#: and its encode, beside its bands).
CODEC_BLOCK = 1 << 28


def column_blocks(k: int, n: int, block: int | None = None) -> list:
    """Column ranges [j, j + step) of a (K, N) matrix, each at most
    ``block`` (default ``CODEC_BLOCK``) elements (one range when the matrix
    is smaller)."""
    block = CODEC_BLOCK if block is None else block
    step = n if k * n <= block else max(1, block // k)
    return [(j, min(j + step, n)) for j in range(0, n, step)]


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
    blocks = column_blocks(k, n, CODEC_BLOCK // 8)
    if len(blocks) > 1:
        parts = [quantize_weight(w[:, j0:j1], group_size) for j0, j1 in blocks]
        return torch.cat([p for p, _ in parts], dim=1), torch.cat([s for _, s in parts], dim=1)
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
    blocks = column_blocks(2 * packed.shape[0], packed.shape[1])
    if len(blocks) > 1:
        return torch.cat([dequantize_weight(packed[:, j0:j1], scales[:, j0:j1], dtype)
                          for j0, j1 in blocks], dim=1)
    codes = unpack_fp4(packed, axis=0)
    k, n = codes.shape
    g = k // scales.shape[0]
    vals = fp4_decode(codes, torch.float32).reshape(k // g, g, n)
    return (vals * scales[:, None, :]).reshape(k, n).to(dtype)


def dequantize_stack(packed: torch.Tensor, scales: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`dequantize_weight` of every matrix of a stack (E, K/2, N), in
    calls over as many matrices as fit ``CODEC_BLOCK`` elements (the same
    elementwise decode, so the same bits as one call a matrix)."""
    e, kh, n = packed.shape
    if 2 * kh * n > CODEC_BLOCK:
        return torch.stack([dequantize_weight(c, s, dtype) for c, s in zip(packed, scales)])
    per = CODEC_BLOCK // (2 * kh * n)
    parts = []
    for i in range(0, e, per):
        codes = unpack_fp4(packed[i:i + per], axis=1)                 # (E', K, N)
        k = codes.shape[1]
        g = k // scales.shape[1]
        vals = fp4_decode(codes, torch.float32).reshape(codes.shape[0], k // g, g, n)
        parts.append((vals * scales[i:i + per, :, None, :]).reshape(-1, k, n).to(dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# --------------------------------------------------------------------------
# Mantissa truncation primitives (FP5 product / FP8 accumulate)
# --------------------------------------------------------------------------

def _mask(mbits: int) -> int:
    """The int32 mask that keeps the sign, the exponent and ``mbits`` bits."""
    m = 0xFFFFFFFF ^ ((1 << (23 - mbits)) - 1)
    return m - (1 << 32) if m >= 1 << 31 else m


def truncate_mantissa_f32(x: torch.Tensor, mbits: int) -> torch.Tensor:
    """Truncate (round toward zero) an f32 mantissa to ``mbits`` bits, on the
    sign-magnitude bits (so right for negatives; a NaN whose payload lies
    below the kept bits becomes +/-inf, as in the reference)."""
    xi = x.to(torch.float32).contiguous().view(torch.int32)
    return (xi & _mask(mbits)).view(torch.float32)


def fp5_e3m1_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's multiplier (Section 10.6): FP4 x FP4 truncated to FP5 E3M1,
    i.e. the f32 product with its mantissa cut to one bit."""
    return truncate_mantissa_f32(a.to(torch.float32) * b.to(torch.float32), 1)


FP8_E4M3_MAX = 448.0
_FP8_MIN_NORMAL = 2.0 ** -6
_FP8_SUB_STEP = 2.0 ** -9


def fp8_e4m3_truncate(x: torch.Tensor) -> torch.Tensor:
    """The accumulator's numerics (Sections 10.4/10.6): FP8 E4M3, saturating
    at +/-448, truncating toward zero, no inf (a NaN stays NaN: the clamp
    keeps it, as ``jnp.clip`` does). Subnormals are multiples of 2^-9."""
    x = x.to(torch.float32)
    sat = torch.clamp(x, -FP8_E4M3_MAX, FP8_E4M3_MAX)
    normal = truncate_mantissa_f32(sat, 3)
    sub = torch.trunc(sat * (1.0 / _FP8_SUB_STEP)) * _FP8_SUB_STEP    # exact: powers of two
    return torch.where(sat.abs() < _FP8_MIN_NORMAL, sub, normal)


def cascade_column_accumulate(products: torch.Tensor,
                              init: torch.Tensor | None = None) -> torch.Tensor:
    """Sum FP5 products (..., K) down a CASCADE column in FP8, in order over
    K; ``init`` is the bias preloaded into the output sum (Section 13.1).
    Returns the (...,) FP8-valued sums in an f32 carrier."""
    acc = (torch.zeros(products.shape[:-1], dtype=torch.float32, device=products.device)
           if init is None else init.to(torch.float32))
    for i in range(products.shape[-1]):
        acc = fp8_e4m3_truncate(acc + products[..., i])
    return acc


def cascade_matmul_exact(x4: torch.Tensor, w4: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Bit-accurate CASCADE matmul (paper Table 6): x4 (..., K) and w4 (K, N)
    FP4-valued in f32, FP5 products, FP8 sums down each column in order over
    K, starting from ``fp8_e4m3_truncate(bias)`` where a bias is given.
    Returns (..., N) f32. Product k's (..., N) slice is made inside the loop
    (the products are elementwise, so the bits are the reference's without
    its (..., K, N) tensor)."""
    x4 = x4.to(torch.float32)
    w4 = w4.to(torch.float32)
    shape = x4.shape[:-1] + (w4.shape[-1],)
    acc = (torch.zeros(shape, dtype=torch.float32, device=x4.device) if bias is None
           else fp8_e4m3_truncate(bias).expand(shape).clone())
    for k in range(x4.shape[-1]):
        acc = fp8_e4m3_truncate(acc + fp5_e3m1_product(x4[..., k, None], w4[k]))
    return acc


# --------------------------------------------------------------------------
# QAT fake quantization (straight-through estimator), paper Section 4
# --------------------------------------------------------------------------

def fake_quant_groups(k: int, group_size: int) -> int:
    """Rows per scale group of a K-row weight: ``group_size`` where it
    divides K, else one group over all K (as the reference)."""
    return group_size if (group_size > 0 and k % group_size == 0) else k


def fake_quant_fp4_plain(w: torch.Tensor, group_size: int = 0,
                         experts: bool = False) -> torch.Tensor:
    """The forward value of :func:`fake_quant_fp4` (no gradient rule): ``w +
    (qdq(w) - f32(w)).to(w.dtype)``, the add in w's dtype, where qdq maps the
    absmax of each (group, column) to 6 and rounds ``w / scale`` onto the
    FP4 grid. Every step is one IEEE operation (the scale's division is a
    tensor by a tensor: a division by a Python number is a multiply by the
    reciprocal on the card). A weight of more than two dims is one (-1, N)
    matrix, as in the reference; with ``experts`` a (E, K, N) stack is E
    matrices, each with its own scales (the reference's ``vmap``)."""
    shape = w.shape
    w3 = w.reshape(shape[0] if experts else 1, -1, shape[-1])
    b, k, n = w3.shape
    g = fake_quant_groups(k, group_size)
    wf = w3.to(torch.float32)
    wg = wf.reshape(b, k // g, g, n)
    absmax = wg.abs().amax(dim=2, keepdim=True)
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, FP4_MAX),
                         torch.ones_like(absmax))
    qdq = (fp4_round(wg / scales) * scales).reshape(b, k, n)
    return (w3 + (qdq - wf).to(w.dtype)).reshape(shape)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``fn(w)``; backward: the incoming gradient as it is."""

    @staticmethod
    def forward(ctx, w, fn):
        return fn(w)

    @staticmethod
    def backward(ctx, g):
        return g, None


def straight_through(w: torch.Tensor, fn) -> torch.Tensor:
    """``fn(w)`` forward, the identity backward (the reference's
    ``w + stop_gradient(f(w) - w)``)."""
    return _StraightThrough.apply(w, fn)


def fake_quant_fp4(w: torch.Tensor, group_size: int = 0, experts: bool = False) -> torch.Tensor:
    """Differentiable FP4 fake quantization, the plain route: forward
    :func:`fake_quant_fp4_plain`, backward the straight-through identity.
    ``kernels.ops.fake_quant_fp4`` is the same function on the kernel route."""
    return straight_through(w, lambda t: fake_quant_fp4_plain(t, group_size, experts))


def fp8_e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to FP8 E4M3 (fn: no inf) and back to x's dtype, as
    ``ml_dtypes`` casts: round to nearest even, and a magnitude past 464
    (which rounds beyond 448), an inf or a NaN becomes NaN of x's sign. Torch's
    own cast saturates there, so those are written explicitly."""
    q = x.to(torch.float8_e4m3fn).to(x.dtype)
    nan = torch.where(torch.signbit(x), -float("nan"), float("nan")).to(x.dtype)
    over = torch.isnan(x) | (x.abs() > 464.0)
    return torch.where(over, nan, q)


def fake_quant_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """FP8 fake quantization with a straight-through gradient (the
    reference's KV-cache QAT experiments): ``x + (q - x)`` in x's dtype."""
    return straight_through(x, lambda t: t + (fp8_e4m3_round(t) - t))
