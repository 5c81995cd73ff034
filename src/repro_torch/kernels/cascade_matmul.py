"""CASCADE FP4 matmul: the Hopper CUDA kernel's launcher and its plain version.

Both compute, for x (M, K) and packed E2M1 weights (K/2, N) with (G, N)
scales (group size K/G, any value that divides K):

    y[m, n] = sum_g scale[g, n] * sum_{k in g} x[m, k] * fp4(code[k, n]) + bias[n]

with the FP4 values exact, products and sums in f32, and one cast to
``out_dtype`` at the end. The kernel is ``csrc/cascade_matmul.cu``; it
replaces the TPU kernel ``cascade_matmul_pallas`` in the JAX package's
``kernels/cascade_matmul.py``. ``kernels.ops.cascade_matmul`` is the
wrapper callers use; :func:`plan` gives the kernel's grid from the shapes.
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built cascade-matmul library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cascade_matmul_launch.restype = ctypes.c_int
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
