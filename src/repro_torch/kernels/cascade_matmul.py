"""CASCADE FP4 matmul: the Hopper CUDA kernel's launcher and its plain version.

Both compute, for x (M, K) and packed E2M1 weights (K/2, N) with (G, N)
scales (group size K/G, any value that divides K):

    y[m, n] = sum_g scale[g, n] * sum_{k in g} x[m, k] * fp4(code[k, n]) + bias[n]

with the FP4 values exact, products and sums in f32, and one cast to
``out_dtype`` at the end. The kernel is ``csrc/cascade_matmul.cu``; it
replaces the TPU kernel ``cascade_matmul_pallas`` in the JAX package's
``kernels/cascade_matmul.py``. ``kernels.ops.cascade_matmul`` is the
wrapper callers use; :func:`plan` gives the kernel's grid from the shapes.

The grouped form computes the same function over E experts in one launch
(the MoE family's expert matmuls, ``kernels.ops.cascade_matmul_grouped``),
through a kernel of its own, ``csrc/cascade_matmul_grouped.cu``: x (E, C,
K), codes (E, K/2, N), scales (E, G, N), no bias, and ``rows`` (E,) int32,
expert e's live rows; rows at or past ``rows[e]`` come out as exact zeros,
and an expert with no live row reads none of its weights. One launch may
take two weight stacks over the same x (gate and up):
:func:`cascade_matmul_grouped_pair_cuda`. :func:`plan_grouped` gives its
launch plan from the shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def cascade_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x: (M, K) with K = 2 * packed rows.
    A weight larger than ``quant.CODEC_BLOCK`` goes by blocks of columns."""
    m, k = x.shape
    n = packed.shape[1]
    blocks = quant.column_blocks(k, n)
    if len(blocks) > 1:
        return torch.cat([cascade_matmul_plain(x, packed[:, j0:j1], scales[:, j0:j1],
                                               None if bias is None else bias[j0:j1], out_dtype)
                          for j0, j1 in blocks], dim=1)
    g = scales.shape[0]
    vals = quant.fp4_decode(quant.unpack_fp4(packed, axis=0), torch.float32)   # (K, N)
    xg = x.to(torch.float32).reshape(m, g, k // g).transpose(0, 1)           # (G, M, K/G)
    part = torch.bmm(xg, vals.reshape(g, k // g, n))                          # (G, M, N)
    out = (part * scales.to(torch.float32)[:, None, :]).sum(dim=0)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def cascade_matmul_grouped_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                                 rows: torch.Tensor | None = None,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the grouped kernel: :func:`cascade_matmul_plain` per
    expert, then rows at or past ``rows[e]`` set to exact zeros."""
    out = torch.stack([cascade_matmul_plain(x[e], packed[e], scales[e], None, out_dtype)
                       for e in range(x.shape[0])])
    if rows is None:
        return out
    live = torch.arange(x.shape[1], device=x.device) < rows.to(x.device)[:, None]   # (E, C)
    return torch.where(live[..., None], out, torch.zeros((), dtype=out.dtype, device=x.device))


def cascade_matmul_grouped_pair_plain(x: torch.Tensor, first: tuple, second: tuple,
                                      rows: torch.Tensor | None = None,
                                      out_dtype=torch.float32) -> tuple:
    """Plain version of the pair launch: :func:`cascade_matmul_grouped_plain`
    of each ``(packed, scales)`` stack over the same x."""
    return tuple(cascade_matmul_grouped_plain(x, p, s, rows, out_dtype) for p, s in (first, second))


#: m-tiles of 16 rows one block holds at most: one group of scales (the
#: serving path), and more than one, where a row keeps a second set of sums
MAX_M_TILES, MAX_M_TILES_GROUPED = 4, 2
_BLOCK_COLS = 32


def plan(m: int, k: int, n: int, group: int = 0) -> dict:
    """The launch's grid, from the shapes alone: a block owns 32 columns and
    ``m_tiles`` m-tiles of 16 rows, all of M up to 64 rows (32 when the
    weights have more than one scale group; ``group`` is the group size, 0
    or K for one group). A call with M up to that reads each packed byte
    once; a larger M takes one block row per 64 (32) rows."""
    cap = MAX_M_TILES if group in (0, k) else MAX_M_TILES_GROUPED
    mt = max(1, min(-(-m // 16), cap))
    return {"m_tiles": mt, "grid": (-(-n // _BLOCK_COLS), -(-m // (16 * mt)))}


#: the grouped kernel's geometry (``csrc/cascade_matmul_grouped.cu``, which
#: refuses a plan with other values): columns an item, ring stages, k16
#: steps of each of the two K slices a stage holds, threads a block
GROUPED_COL_TILE, GROUPED_STAGES, GROUPED_STEPS, GROUPED_THREADS = 128, 3, 8, 256
#: its shared memory: the decode table (one copy a lane), a k16 step's
#: packed rows (8 of 128 bytes) and x (16 rows of 32 bytes), and the odd
#: slice's sums handed to the even warps
_GROUPED_LUT_BYTES, _GROUPED_W_STEP, _GROUPED_X_STEP = 256 * 32 * 4, 8 * 128, 16 * 32
_GROUPED_XCH_BYTES = 4 * 4 * 32 * 16
#: an H100 SM's shared memory, and what the runtime keeps of it a block
SM_SMEM_BYTES, BLOCK_RESERVED_SMEM = 233472, 1024


def plan_grouped(e: int, n: int) -> dict:
    """The grouped launch's plan for E experts and N columns, from the
    shapes alone. An item is (expert, m-tile of 16 rows, stack, 128-column
    tile): an expert's routed rows are few (a decode step's C = 8 fits one
    m-tile; at a verify pass's 40, the few experts with over 16 rows take two
    items a column tile). ``smem_bytes`` is the decode table, the ring of
    ``stages`` stages (``steps_a_stage`` k16 steps of each of two K slices),
    the odd slice's hand-over and the prefix of the E experts' m-tiles: two
    blocks an SM fit it up to E = 255 (the served models have 64-160), one
    up to E = 29,439, and the kernel refuses more. The blocks launched come
    from :func:`grouped_blocks`, on the card."""
    ring = GROUPED_STAGES * 2 * GROUPED_STEPS * (_GROUPED_W_STEP + _GROUPED_X_STEP)
    smem = _GROUPED_LUT_BYTES + ring + _GROUPED_XCH_BYTES + -(-4 * (e + 1) // 16) * 16
    return {"col_tile": GROUPED_COL_TILE, "col_tiles": -(-n // GROUPED_COL_TILE),
            "stages": GROUPED_STAGES, "steps_a_stage": GROUPED_STEPS,
            "threads": GROUPED_THREADS, "smem_bytes": smem}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built cascade-matmul library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cascade_matmul_launch.restype = ctypes.c_int
    lib.cascade_matmul_geometry.argtypes = [p]
    lib.cascade_matmul_geometry.restype = None
    return lib


def bind_grouped(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built grouped-matmul library."""
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.cascade_matmul_grouped_launch.argtypes = [p, p, p, p, p, p, p, p] + [i] * 11 + [p]
    lib.cascade_matmul_grouped_launch.restype = ctypes.c_int
    lib.cascade_matmul_grouped_occupancy.argtypes = [i, i, i, ip, ip]
    lib.cascade_matmul_grouped_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    return bind(build.load("cascade_matmul"))


@functools.lru_cache(maxsize=None)
def _grouped_library():
    """The grouped kernel's library, built and loaded at first use."""
    return bind_grouped(build.load("cascade_matmul_grouped"))


@functools.lru_cache(maxsize=None)
def grouped_occupancy(out_bf16: bool, mode: int, smem_bytes: int) -> dict:
    """Blocks of the grouped kernel (bf16 or f32 out; ``mode``: 0 one scale
    group, 1 groups on the 16-row step, 2 off it) that fit an SM at
    ``smem_bytes``, and the card's SMs: the runtime's occupancy count, asked
    once per instantiation and size."""
    fit, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = _grouped_library().cascade_matmul_grouped_occupancy(
        int(out_bf16), mode, smem_bytes, ctypes.byref(fit), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"cascade_matmul_grouped occupancy query failed: CUDA error {rc}")
    return {"blocks_per_sm": fit.value, "sms": sms.value}


def grouped_mode(k: int, group: int) -> int:
    """The grouped kernel's scale-group mode: 0 one group, 1 groups on the
    16-row step, 2 off it."""
    return 0 if group == k else 1 if group % 16 == 0 else 2


def grouped_blocks(pl: dict, k: int, group: int, out_dtype) -> int:
    """The persistent grid of plan ``pl``: as many blocks as fit on the card
    at once (two an SM at the served shapes)."""
    occ = grouped_occupancy(out_dtype == torch.bfloat16, grouped_mode(k, group),
                            pl["smem_bytes"])
    return occ["blocks_per_sm"] * occ["sms"]


def geometry() -> dict:
    """The built kernel's m-tiles a block at most (one scale group, more
    than one) and the k16 steps a warp batches at 1-4 m-tiles."""
    out = (ctypes.c_int * 6)()
    _library().cascade_matmul_geometry(ctypes.addressof(out))
    return {"max_m_tiles": out[0], "max_m_tiles_grouped": out[1],
            "batch_steps_by_m_tiles": list(out[2:])}


def cascade_matmul_cuda(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does not
    take. The kernel multiplies bf16 activations on tensor cores: an f32 ``x``
    raises (the card's compute dtype is bf16)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"cascade_matmul_cuda needs CUDA tensors, got {dev}")
    for name, t in (("packed", packed), ("scales", scales), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("x, packed and scales must be 2-D")
    m, k = x.shape
    n = packed.shape[1]
    if k != 2 * packed.shape[0] or scales.shape[1] != n or k % scales.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)} do not agree")
    if x.dtype != torch.bfloat16 or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"x dtype {x.dtype} / out dtype {out_dtype} not supported")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise ValueError("packed must be uint8 and scales f32")
    if bias is not None and (bias.dtype != torch.float32 or bias.numel() != n):
        raise ValueError("bias must be f32 with N elements")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("cascade_matmul_cuda needs contiguous operands")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    group = k // scales.shape[0]
    rc = _library().cascade_matmul_launch(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        m, k, n, group, int(out_dtype == torch.bfloat16), plan(m, k, n, group)["m_tiles"],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cascade_matmul kernel launch failed: CUDA error {rc}")
    return out


def _check_grouped(x: torch.Tensor, stacks, rows: torch.Tensor, out_dtype):
    """Raise on grouped operands the kernel does not take; returns E, C, K, N."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"cascade_matmul_grouped_cuda needs CUDA tensors, got {dev}")
    for name, t in [("rows", rows)] + [(n, t) for p, s in stacks
                                       for n, t in (("packed", p), ("scales", s))]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 3 or rows.dim() != 1 or any(p.dim() != 3 or s.dim() != 3 for p, s in stacks):
        raise ValueError("x, packed and scales must be 3-D and rows 1-D")
    e, c, k = x.shape
    packed, scales = stacks[0]
    n = packed.shape[2]
    for p, s in stacks:
        if (p.shape != packed.shape or s.shape != scales.shape or p.shape[0] != e
                or s.shape[0] != e or rows.shape[0] != e or k != 2 * p.shape[1]
                or s.shape[2] != n or k % s.shape[1]):
            raise ValueError(f"shapes x {tuple(x.shape)}, packed {tuple(p.shape)}, "
                             f"scales {tuple(s.shape)}, rows {tuple(rows.shape)} do not agree")
    if x.dtype != torch.bfloat16 or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"x dtype {x.dtype} / out dtype {out_dtype} not supported")
    if (any(p.dtype != torch.uint8 or s.dtype != torch.float32 for p, s in stacks)
            or rows.dtype != torch.int32):
        raise ValueError("packed must be uint8, scales f32 and rows int32")
    if not (x.is_contiguous() and rows.is_contiguous()
            and all(p.is_contiguous() and s.is_contiguous() for p, s in stacks)):
        raise ValueError("cascade_matmul_grouped_cuda needs contiguous operands")
    return e, c, k, n


def _launch_grouped(x: torch.Tensor, stacks, rows: torch.Tensor, out_dtype) -> tuple:
    """One launch over one or two ``(packed, scales)`` stacks; their outputs."""
    e, c, k, n = _check_grouped(x, stacks, rows, out_dtype)
    outs = tuple(torch.empty((e, c, n), dtype=out_dtype, device=x.device) for _ in stacks)
    if e == 0 or c == 0 or n == 0:
        return outs
    group = k // stacks[0][1].shape[1]
    pl = plan_grouped(e, n)
    (p0, s0), (p1, s1) = stacks[0], (stacks[1] if len(stacks) > 1 else (None, None))
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = _grouped_library().cascade_matmul_grouped_launch(
        x.data_ptr(), p0.data_ptr(), s0.data_ptr(), outs[0].data_ptr(), ptr(p1), ptr(s1),
        ptr(outs[1]) if len(outs) > 1 else None, rows.data_ptr(), e, c, k, n, group,
        int(out_dtype == torch.bfloat16), pl["col_tile"], pl["stages"], pl["threads"],
        pl["smem_bytes"], grouped_blocks(pl, k, group, out_dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cascade_matmul_grouped kernel launch failed: CUDA error {rc}")
    return outs


def cascade_matmul_grouped_cuda(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                                rows: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Launch the grouped kernel on CUDA tensors: x (E, C, K) bf16, packed
    (E, K/2, N) uint8, scales (E, G, N) f32, rows (E,) int32 on the card
    (read there: no host sync). Returns (E, C, N); raises on anything the
    kernel does not take."""
    return _launch_grouped(x, ((packed, scales),), rows, out_dtype)[0]


def cascade_matmul_grouped_pair_cuda(x: torch.Tensor, first: tuple, second: tuple,
                                     rows: torch.Tensor, out_dtype=torch.float32) -> tuple:
    """One launch of the grouped kernel over two weight stacks of one shape,
    ``first`` and ``second`` each ``(packed, scales)``, and the same x and
    rows (the MoE layer's gate and up). Returns the two (E, C, N) outputs,
    each with the bits :func:`cascade_matmul_grouped_cuda` gives it."""
    return _launch_grouped(x, (tuple(first), tuple(second)), rows, out_dtype)
