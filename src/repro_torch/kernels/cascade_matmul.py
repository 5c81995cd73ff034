"""CASCADE FP4 matmul: the Hopper CUDA kernel's launcher and its plain version.

Both compute, for x (M, K) and packed E2M1 weights (K/2, N) with (G, N)
scales (group size K/G, any value that divides K):

    y[m, n] = sum_g scale[g, n] * sum_{k in g} x[m, k] * fp4(code[k, n]) + bias[n]

with the FP4 values exact, products and sums in f32, and one cast to
``out_dtype`` at the end. The kernel is ``csrc/cascade_matmul.cu``; it
replaces the TPU kernel ``cascade_matmul_pallas`` in the JAX package's
``kernels/cascade_matmul.py``. ``kernels.ops.cascade_matmul`` is the
wrapper callers use; :func:`plan` gives the kernel's grid from the shapes.

The grouped form runs the same kernel over E experts in one launch (the
MoE family's expert matmuls, ``kernels.ops.cascade_matmul_grouped``): x (E,
C, K), codes (E, K/2, N), scales (E, G, N), no bias, and ``rows`` (E,)
int32, expert e's live rows; rows at or past ``rows[e]`` come out as exact
zeros, and an expert with no live row reads none of its weights.
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
    """Plain PyTorch version of the kernel. x: (M, K) with K = 2 * packed rows."""
    m, k = x.shape
    n = packed.shape[1]
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


def plan_grouped(e: int, c: int, n: int) -> dict:
    """The grouped launch's grid for E experts of C rows and N columns: one
    m-tile (16 rows) a block, a block row per 16 of the C rows, one grid
    layer per expert. An expert's routed rows are few, so more m-tiles a
    block would mostly be dead; a block past its expert's rows exits at
    once."""
    return {"m_tiles": 1, "grid": (-(-n // _BLOCK_COLS), -(-c // 16), e)}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built cascade-matmul library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cascade_matmul_launch.restype = ctypes.c_int
    lib.cascade_matmul_grouped_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.cascade_matmul_grouped_launch.restype = ctypes.c_int
    lib.cascade_matmul_geometry.argtypes = [p]
    lib.cascade_matmul_geometry.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    return bind(build.load("cascade_matmul"))


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


def cascade_matmul_grouped_cuda(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                                rows: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Launch the grouped kernel on CUDA tensors: x (E, C, K) bf16, packed
    (E, K/2, N) uint8, scales (E, G, N) f32, rows (E,) int32 on the card
    (read there: no host sync). Returns (E, C, N); raises on anything the
    kernel does not take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"cascade_matmul_grouped_cuda needs CUDA tensors, got {dev}")
    for name, t in (("packed", packed), ("scales", scales), ("rows", rows)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 3 or packed.dim() != 3 or scales.dim() != 3 or rows.dim() != 1:
        raise ValueError("x, packed and scales must be 3-D and rows 1-D")
    e, c, k = x.shape
    n = packed.shape[2]
    if (packed.shape[0] != e or scales.shape[0] != e or rows.shape[0] != e
            or k != 2 * packed.shape[1] or scales.shape[2] != n or k % scales.shape[1]):
        raise ValueError(f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, rows {tuple(rows.shape)} do not agree")
    if x.dtype != torch.bfloat16 or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"x dtype {x.dtype} / out dtype {out_dtype} not supported")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32 or rows.dtype != torch.int32:
        raise ValueError("packed must be uint8, scales f32 and rows int32")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("cascade_matmul_grouped_cuda needs contiguous operands")
    out = torch.empty((e, c, n), dtype=out_dtype, device=dev)
    if e == 0 or c == 0 or n == 0:
        return out
    group = k // scales.shape[1]
    rc = _library().cascade_matmul_grouped_launch(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), rows.data_ptr(), out.data_ptr(),
        e, c, k, n, group, int(out_dtype == torch.bfloat16),
        plan_grouped(e, c, n)["m_tiles"], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cascade_matmul_grouped kernel launch failed: CUDA error {rc}")
    return out
