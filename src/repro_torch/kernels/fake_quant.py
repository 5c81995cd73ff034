"""FP4 fake quantization for QAT: the Hopper CUDA kernel's launcher, its
launch plan and its plain version.

``w + (qdq(w) - f32(w)).to(w.dtype)`` with ``qdq`` the absmax FP4 round
trip of each (group, column) of a (K, N) weight (``core/quant.py``,
:func:`~repro_torch.core.quant.fake_quant_fp4_plain`, is the plain version).
A weight of more dims is one (-1, N) matrix, or, with ``experts``, a
(E, K, N) stack of E matrices with scales of their own. The kernel is
``csrc/fake_quant.cu``; there is no TPU kernel (the reference's
``fake_quant_fp4`` is plain XLA). ``kernels.ops.fake_quant_fp4`` is the
wrapper callers use: it adds the straight-through gradient.
"""
from __future__ import annotations

import ctypes
import functools
import types
from collections.abc import Mapping

import torch

from repro_torch.core.quant import fake_quant_fp4_plain, fake_quant_groups
from repro_torch.kernels import build

__all__ = ["fake_quant_fp4_plain", "fake_quant_fp4_cuda", "plan", "geometry", "best_cluster",
           "launch_plan"]

#: the H100's SMs: the plan seeks two slabs of work an SM
SMS = 132
#: threads a block; the largest thread-block cluster that is portable
THREADS, MAX_CLUSTER = 256, 8
#: copies a thread makes a chunk: 16-byte ones, or single elements; a block
#: double-buffers its chunk in shared memory, so LOADS_PREFERRED 16-byte
#: copies (32 KB a buffer, 64 KB a block) leave room for 3 blocks an SM, and
#: LOADS_MAX (128 KB a block) for one
LOADS_PREFERRED, LOADS_MAX = 8, 16
SCALAR_LOADS_MAX = 64


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("fake_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fake_quant_fp4_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_int), p]
    lib.fake_quant_fp4_launch.restype = ctypes.c_int
    return lib


def geometry(b: int, k: int, n: int, g: int, elsize: int, aligned: bool, tpr: int,
             cluster: int, cap: int) -> dict | None:
    """The launch geometry for ``b`` (k, n) matrices of ``elsize``-byte
    elements in groups of ``g`` rows, ``tpr`` threads a strip row, a cluster
    of ``cluster`` blocks a group and at most ``cap`` copies a thread a
    chunk; None where a block of the cluster would hold no row.

    A thread copies 16 bytes (``vec`` elements) where a row is 16-byte
    aligned (``aligned`` and ``n * elsize`` a multiple of 16), else one
    element; ``tpr`` threads cover a strip row of ``cols = tpr * vec``
    columns, and a block's 256 threads ``lanes = 256 / tpr`` rows at a time.
    An item is a strip of one group; its rows are split over the cluster,
    ``rows`` consecutive rows a block (the last takes the remainder), which
    a block walks in ``chunks`` chunks of ``loads`` copies a thread: one
    chunk keeps the slab on chip, more read the group twice."""
    vec = 16 // elsize if aligned and (n * elsize) % 16 == 0 else 1
    lanes, cols = THREADS // tpr, tpr * vec
    rows = -(-g // cluster)
    if (cluster - 1) * rows >= g:
        return None
    per_thread = -(-rows // lanes)
    chunks = -(-per_thread // cap)
    loads = -(-per_thread // chunks)
    strips = -(-n // cols)
    items = strips * (k // g) * b
    return {"vec": vec, "tpr": tpr, "cols": cols, "lanes": lanes, "cluster": cluster,
            "rows": rows, "loads": loads, "chunks": chunks, "strips": strips, "items": items,
            "slabs": items * cluster,
            "slab_bytes": THREADS * loads * (16 if vec > 1 else elsize)}


def best_cluster(b: int, k: int, n: int, g: int, elsize: int, aligned: bool, tpr: int,
                 cap: int) -> dict | None:
    """At strip width ``tpr`` and ``cap`` copies, the one-chunk geometry of
    the smallest cluster whose work holds two slabs an SM, else of the
    largest cluster that fits; None where no cluster holds a group in one
    chunk."""
    fits = [geo for s in range(1, MAX_CLUSTER + 1)
            if (geo := geometry(b, k, n, g, elsize, aligned, tpr, s, cap)) and geo["chunks"] == 1]
    return next((geo for geo in fits if geo["slabs"] >= 2 * SMS), fits[-1] if fits else None)


@functools.lru_cache(maxsize=None)
def plan(b: int, k: int, n: int, g: int, elsize: int, aligned: bool = True) -> Mapping:
    """The kernel's launch geometry (:func:`geometry`, read-only) for ``b``
    (k, n) matrices of ``elsize``-byte elements in groups of ``g`` rows.

    The widest strip row (128 bytes) and then the smallest cluster come
    first, among plans whose slab takes one chunk of at most 8 copies a
    thread (3 blocks an SM), else 16 (64 one-element copies); the cluster
    grows, and then the strip narrows, while the work holds fewer than two
    slabs an SM (where none reaches two, a small weight, the plan with the
    most slabs is taken). On an H100 the widest strip that fits 8 copies
    was the fastest at every shape of ``chip_smoke.FQ_SHAPES``
    (``scripts/qat_kernels_sweep.py --fq-widths``): wider rows read device
    memory in longer runs, more blocks an SM overlap one item's loads with
    another's arithmetic. A group taller than 8 blocks hold in one chunk
    (over 16,384 rows) takes a cluster of 8 and chunks of 8 copies (64
    one-element ones), at the widest strip that holds two slabs an SM."""
    if min(b, k, n, g) < 1 or k % g:
        raise ValueError(f"fake-quant plan: b={b} k={k} n={n} g={g}")
    vector = aligned and (n * elsize) % 16 == 0
    widths = (8, 4, 2) if vector else (32, 16, 8)
    caps = (LOADS_PREFERRED, LOADS_MAX) if vector else (SCALAR_LOADS_MAX,)
    best = None
    for cap in caps:
        for t in widths:
            cand = best_cluster(b, k, n, g, elsize, aligned, t, cap)
            if cand is None:
                continue
            if cand["slabs"] >= 2 * SMS:
                return types.MappingProxyType(cand)
            if best is None or cand["slabs"] > best["slabs"]:
                best = cand
        if best is not None:
            return types.MappingProxyType(best)
    chunked = [geometry(b, k, n, g, elsize, aligned, t, MAX_CLUSTER, caps[0]) for t in widths]
    return types.MappingProxyType(next((geo for geo in chunked if geo["slabs"] >= 2 * SMS),
                                       max(chunked, key=lambda geo: geo["slabs"])))


def fake_quant_fp4_cuda(w: torch.Tensor, group_size: int = 0,
                        experts: bool = False) -> torch.Tensor:
    """Launch the kernel on a bf16 or f32 CUDA weight; raises on anything it
    does not take. Returns a new tensor of w's shape and dtype."""
    if w.device.type != "cuda":
        raise ValueError(f"the fake-quant kernel needs a CUDA tensor, got {w.device}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the fake-quant kernel takes bf16 or f32 weights, got {w.dtype}")
    if w.dim() < 2 or (experts and w.dim() != 3):
        raise ValueError(f"fake quantization takes a (K, N) weight, or a (E, K, N) expert "
                         f"stack with experts=True; got shape {tuple(w.shape)}")
    n = w.shape[-1]
    b = w.shape[0] if experts else 1
    k = w.numel() // (n * b)
    g = fake_quant_groups(k, group_size)
    wc = w.contiguous()
    out = torch.empty_like(wc)
    if w.numel():
        pl = plan(b, k, n, g, w.element_size(),
                  aligned=wc.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        launch_plan(wc, out, b, k, n, g, pl)
    return out


def launch_plan(w: torch.Tensor, out: torch.Tensor, b: int, k: int, n: int, g: int,
                pl: Mapping) -> int:
    """Launch the kernel with plan ``pl`` on contiguous CUDA ``w`` and
    ``out``, as many clusters as fit on the card at once. Returns the
    clusters launched; raises on a launch error."""
    fit = ctypes.c_int(0)
    rc = _library().fake_quant_fp4_launch(
        w.data_ptr(), out.data_ptr(), b, k, n, g, pl["vec"], pl["tpr"], pl["cluster"],
        pl["rows"], pl["loads"], pl["chunks"], int(w.dtype == torch.bfloat16), ctypes.byref(fit),
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_fp4 kernel launch failed: CUDA error {rc}")
    return min(fit.value, pl["items"])
