"""Public wrappers for the port's kernels: padding, reshapes and dispatch.

A tensor on the CPU goes to the kernel's plain version; a CUDA tensor goes
to the CUDA kernel, which launches or raises. There is no fallback from one
to the other. Every kernel launch adds one to ``LAUNCHES[name]``, so a run
can show that its path went through the kernels.

Gradients: the fake-quant kernel's is the straight-through identity, as its
plain version's. The norm and flash-attention kernels have no backward of
their own (nor had the TPU kernels); where autograd records a call (a
training forward on the kernel route), their outputs come from the kernel
and their gradient is the plain version's, recomputed in the backward from
the saved inputs. A call autograd does not record launches alone. That
backward runs inside the profiler range ``PLAIN_GRADIENT`` (its recompute
inside ``PLAIN_GRADIENT + ".recompute"``), so a profiled step reads its
device time apart.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core import quant as _quant
from repro_torch.kernels import cascade_exact as _ce
from repro_torch.kernels import cascade_matmul as _cm
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import norm as _norm
from repro_torch.kernels import ssd_scan as _ssd

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"cascade_matmul": 0, "cascade_matmul_exact": 0, "cascade_matmul_grouped": 0,
            "decode_attention": 0, "fake_quant_fp4": 0, "flash_attention": 0, "norm": 0,
            "ssd_scan": 0}


#: profiler range of :class:`_PlainGradient`'s backward
PLAIN_GRADIENT = "ops.plain_gradient"

#: (rows of a call, rows it plans for) while :func:`planned_rows` is on
_PLAN_ROWS: tuple | None = None


@contextlib.contextmanager
def planned_rows(local: int, whole: int):
    """Inside, an attention launch over ``local`` rows (a data shard's band
    of a mesh engine's slot grid) chooses its split over the keys as one
    over ``whole`` rows would, so each row takes the unsharded grid's
    launch plan and bits. Other launches plan as they are."""
    global _PLAN_ROWS
    prev, _PLAN_ROWS = _PLAN_ROWS, (local, whole)
    try:
        yield
    finally:
        _PLAN_ROWS = prev


def _plan_kw(b: int) -> dict:
    """The ``plan_rows`` keyword of a launch over ``b`` rows, given only
    inside :func:`planned_rows` (outside, a launch keeps the wrappers' own
    signature, which a plain version stands in for on the card)."""
    if _PLAN_ROWS is None or _PLAN_ROWS[0] != b:
        return {}
    return {"plan_rows": _PLAN_ROWS[1]}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for a tensor on {t.device}")


class _PlainGradient(torch.autograd.Function):
    """Forward: ``launch(*inputs)`` (the kernel); backward: the gradient of
    ``plain(*inputs)``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, launch, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.profiler.record_function(PLAIN_GRADIENT):
            leaves = [t.detach().requires_grad_(nd) if t is not None else None
                      for t, nd in zip(ctx.saved_tensors, need)]
            with torch.enable_grad(), torch.profiler.record_function(PLAIN_GRADIENT
                                                                     + ".recompute"):
                out = ctx.plain(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [t for t, nd in zip(leaves, need) if nd]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs else [None] * len(wrt))
            return (None, None) + tuple(next(got) if nd else None for nd in need)


def _kernel_call(launch, plain, *inputs):
    """``launch(*inputs)``; where autograd records the call, through
    :class:`_PlainGradient` (so the plain version gives the gradient)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _PlainGradient.apply(launch, plain, *inputs)
    return launch(*inputs)


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


def cascade_matmul_grouped(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                           rows: torch.Tensor | None = None, *,
                           out_dtype=torch.float32) -> torch.Tensor:
    """E FP4-packed weight matmuls in one launch (the MoE experts): x (E, C,
    K) @ Wq[e] (K, N) -> (E, C, N). ``rows`` (E,) int32: expert e's live
    rows, from the dispatch; rows at or past ``rows[e]`` come out as exact
    zeros (None: all C rows live). No bias. Odd-K weights take a zero
    activation column, as in :func:`cascade_matmul`."""
    if packed.shape[1] * 2 == x.shape[-1] + 1:
        x = F.pad(x, (0, 1))
    if _route(x) == "cuda":
        if rows is None:
            rows = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        out = _cm.cascade_matmul_grouped_cuda(x.contiguous(), packed, scales, rows, out_dtype)
        LAUNCHES["cascade_matmul_grouped"] += 1
        return out
    return _cm.cascade_matmul_grouped_plain(x, packed, scales, rows, out_dtype)


def cascade_matmul_grouped_pair(x: torch.Tensor, first: tuple, second: tuple,
                                rows: torch.Tensor | None = None, *,
                                out_dtype=torch.float32) -> tuple:
    """Two stacks of E FP4 expert matmuls over the same x in ONE launch (the
    MoE layer's gate and up): ``first`` and ``second`` are ``(packed,
    scales)`` of one shape; returns their two (E, C, N) outputs, each with
    the bits :func:`cascade_matmul_grouped` gives it. On the CPU, two plain
    grouped calls."""
    if first[0].shape[1] * 2 == x.shape[-1] + 1:
        x = F.pad(x, (0, 1))
    if _route(x) == "cuda":
        if rows is None:
            rows = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        out = _cm.cascade_matmul_grouped_pair_cuda(x.contiguous(), first, second, rows,
                                                   out_dtype)
        LAUNCHES["cascade_matmul_grouped"] += 1
        return out
    return _cm.cascade_matmul_grouped_pair_plain(x, first, second, rows, out_dtype)


def fake_quant_fp4(w: torch.Tensor, group_size: int = 0, *,
                   experts: bool = False) -> torch.Tensor:
    """QAT's FP4 fake quantization with the straight-through gradient: ``w +
    (qdq(w) - f32(w)).to(w.dtype)``, scales per (group, column) of the (K, N)
    weight (a weight of more dims is one (-1, N) matrix; with ``experts`` a
    (E, K, N) stack is E matrices, one launch for all of them). ``group_size``
    0, or one that does not divide K, means one group over K."""
    if _route(w) == "cuda":
        def launch(t):
            out = _fq.fake_quant_fp4_cuda(t, group_size, experts)
            LAUNCHES["fake_quant_fp4"] += 1
            return out
        return _quant.straight_through(w, launch)
    return _quant.fake_quant_fp4(w, group_size, experts)


def cascade_matmul_exact(x4: torch.Tensor, w4: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """The bit-accurate CASCADE matmul: x4 (..., K) and w4 (K, N) FP4-valued
    f32, FP5 products summed down each column in FP8 in order over K (from
    the FP8 bias where one is given). Returns (..., N) f32."""
    lead = x4.shape[:-1]
    if _route(x4) == "cuda":
        out = _ce.cascade_matmul_exact_cuda(x4.reshape(-1, x4.shape[-1]), w4, bias)
        LAUNCHES["cascade_matmul_exact"] += 1
        return out.reshape(*lead, w4.shape[-1])
    return _ce.cascade_matmul_exact_plain(x4, w4, bias)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor | None = None, *, scale: float | None = None,
                     q_pos: torch.Tensor | None = None, return_lse: bool = False):
    """Decode-step attention on a stacked cache. q: (B, Hq, D), one query
    token per slot; k/v: (B, T, Hkv, D) cache buffers. Key t of row b is
    live iff ``t <= q_pos[b]`` (q_pos: (B,) int32, the row's position; the
    kernel then reads no row past it) and ``valid[b, t]`` is nonzero; either
    may be absent. Returns (B, Hq, D) f32; with ``return_lse`` also each
    row's log-sum-exp (B, Hq) f32 (-inf where no key is live), the weight
    of a band of T in a merge with the other bands."""
    lse_kw = {"return_lse": True} if return_lse else {}
    if _route(q) == "cuda":
        out = _da.decode_attention_cuda(q.contiguous(), k, v, valid, scale, q_pos,
                                        **_plan_kw(q.shape[0]), **lse_kw)
        LAUNCHES["decode_attention"] += 1
        return out
    return _da.decode_attention_plain(q, k, v, valid, scale, q_pos, **lse_kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: float | None = None, q_offset: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None, window: int = 0) -> torch.Tensor:
    """Blocked self-attention, GQA-aware. q: (B, Hq, S, D); k/v: (B, Hkv,
    T, D). Causal: query i of row b sees key j iff ``j <= q_offset[b] + i``
    (q_offset: (B,) int32, zeros when absent, so with T == S the plain
    causal mask). Local attention: key j sits at position ``k_pos[b, j]``
    ((B, T) int32, ``j`` when absent, < 0 for no key) and is visible iff
    that position is >= 0, <= the query's and, with ``window`` > 0, less
    than ``window`` behind it. Returns (B, Hq, S, D) in q's dtype. The CUDA
    kernel takes bf16 q over bf16 or float8_e4m3fn k/v and reads q/k/v
    through their strides, so k/v
    may be a cache's live prefix (its launch plan follows T)."""
    if _route(q) == "cuda":
        out = _kernel_call(
            lambda q, k, v: _fa.flash_attention_cuda(q, k, v, causal, scale, q_offset, k_pos,
                                                     window, **_plan_kw(q.shape[0])),
            lambda q, k, v: _fa.flash_attention_plain(q, k, v, causal, scale, q_offset, k_pos,
                                                      window), q, k, v)
        LAUNCHES["flash_attention"] += 1
        return out
    return _fa.flash_attention_plain(q, k, v, causal, scale, q_offset, k_pos, window)


def norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None, *,
         norm_type: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis in f32, out in x's dtype. The
    CUDA kernel sums each row in one order fixed by the width, so a row
    rounds alike whatever the number of rows in the call."""
    if _route(x) == "cuda":
        out = _kernel_call(lambda *t: _norm.norm_cuda(*t, norm_type, eps),
                           lambda *t: _norm.norm_plain(*t, norm_type, eps), x, scale, bias)
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
        out = _kernel_call(lambda *t: _norm.add_norm_cuda(*t, norm_type, eps),
                           lambda *t: _norm.add_norm_plain(*t, norm_type, eps),
                           x, r, scale, bias)
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
        out = _kernel_call(lambda *t: _norm.gated_norm_cuda(*t, eps),
                           lambda *t: _norm.gated_norm_plain(*t, eps), y, z, scale)
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
