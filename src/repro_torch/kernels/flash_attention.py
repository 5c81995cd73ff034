"""Flash attention: the Hopper CUDA kernel's launcher and its plain version.

Causal (or full) self-attention in the reference's layout: q (B, Hq, S, D),
k/v (B, Hkv, T, D); GQA maps q head h to kv head h // (Hq / Hkv). Under
``causal`` query i of row b sees key j iff ``j <= q_offset[b] + i``: with
``q_offset`` zero and T == S that is the TPU kernel's causal mask, and with
``q_offset`` the rows' cache positions it is the reference's extend
attention (a chunk appended to each row's cache). Two optional arguments
make it local attention: ``k_pos`` (B, T) int32 gives key j's position
(``j`` when absent; < 0 marks no key), and ``window`` > 0 hides keys
``window`` or more positions behind the query. Key j is then visible iff
``0 <= k_pos[b, j] <= q_offset[b] + i`` and, with a window, ``q_offset[b] +
i - k_pos[b, j] < window``: a windowed prompt (no ``k_pos``), and the
reference's ring-buffer extend, whose keys are the ring's rows at their
``slot_pos`` followed by the chunk's own. Scores are scaled,
masked to -1e30, soft-maxed over T and contracted with v in f32; the result
is (B, Hq, S, D) in q's dtype, as the TPU kernel writes it.

An FP8 cache (k/v ``float8_e4m3fn``, q bf16) is upcast by the plain
version and converted to bf16 as the kernel stages it (exact), so the
kernel's result is its result on the cache upcast to bf16, bit for bit.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` in the JAX package's ``kernels/flash_attention.py``.
``kernels.ops.flash_attention`` is the wrapper callers use. A block holds
64 (query position, head) rows over the query heads of one KV head; a small
grid over many keys splits each block's keys across blocks (:func:`plan`)
and merges the partials (:func:`merge_partials`; :func:`split_plain` is
that route in plain PyTorch). A caller attending over a cache hands in only
its live prefix (``layers.attn_apply``'s ``kv_len``), so T, and with it the
split, follows the keys the chunk can see.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 96, 128, 256)


def check_local(causal: bool, k_pos: torch.Tensor | None, window: int, b: int, t: int,
                device) -> None:
    """Raise unless ``k_pos`` is absent or a (b, t) int32 tensor on ``device``
    and ``window`` >= 0; both apply to causal attention only."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not causal and (k_pos is not None or window):
        raise ValueError("k_pos and window apply to causal attention only")
    if k_pos is not None and (k_pos.dtype != torch.int32 or tuple(k_pos.shape) != (b, t)
                              or k_pos.device != device):
        raise ValueError(f"k_pos must be ({b}, {t}) int32 on {device}, got "
                         f"{tuple(k_pos.shape)} {k_pos.dtype} on {k_pos.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          q_offset: torch.Tensor | None = None,
                          k_pos: torch.Tensor | None = None, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's masked softmax)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    check_local(causal, k_pos, window, b, t, q.device)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(torch.float32)) * scale
    if causal:
        off = (torch.zeros((b,), dtype=torch.int64, device=q.device) if q_offset is None
               else q_offset.to(torch.int64))
        rows = off[:, None, None] + torch.arange(s, device=q.device)[:, None]   # (B, S, 1)
        kp = (torch.arange(t, device=q.device)[None, None, :] if k_pos is None
              else k_pos.to(torch.int64)[:, None, :])                            # (B|1, 1, T)
        visible = (kp >= 0) & (kp <= rows)
        if window > 0:
            visible &= rows - kp < window
        logits = logits.masked_fill(~visible[:, None, None], -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))
    return o.reshape(b, hq, s, d).to(q.dtype)


#: (query position, head) rows one block holds
_BLOCK_ROWS = 64
_MAX_HEADS = 16       # query heads one block holds (a larger group takes several)
_MAX_SPLITS = 16
_SPLIT_FROM_KEYS = 256  # fewer keys than this keep one split
_MIN_SPLIT_KEYS = 64    # a split gets at least this many keys (two tiles)
_KEYS_PER_TILE = 32   # the default build's tile (``geometry()`` reads the built one)
_LOG2E = 1.4426950408889634


def heads_per_block(group: int) -> int:
    """Query heads one block holds: the whole group up to 16, else the group
    cut into the fewest equal chunks of at most 16."""
    return -(-group // -(-group // _MAX_HEADS))


def plan(b: int, hq: int, hkv: int, s: int, t: int, *, sms: int = 132) -> dict:
    """The launch's grid, from the shapes alone (never from q_offset, so the
    call does not sync and can be captured in a CUDA graph): a block holds
    64 (position, head) rows over the heads of one KV head. When the blocks
    are fewer than the card's SMs and T holds at least ``_SPLIT_FROM_KEYS``
    keys, each block's keys are split across blocks: as many splits as
    bring the grid to two blocks an SM at most, each split at least
    ``_MIN_SPLIT_KEYS`` keys, 16 at most. T is the keys the call may read:
    the engine hands in a cache's live prefix, so the split follows the
    live keys. On an H100 (``scripts/flash_attention_sweep.py``) the merge
    launch costs more than the extra blocks win below 256 live keys; the
    blocks are latency-bound, so two share an SM well (8 splits of 32
    blocks beat 4, and 5, which gives some SMs two blocks and most one,
    loses to both); and a grid that fills the card (a causal GQA prompt of
    512 at 200 blocks) runs slower split."""
    group = hq // hkv
    hpb = heads_per_block(group)
    chunks = -(-group // hpb)
    positions = _BLOCK_ROWS // hpb
    q_tiles = -(-s // positions)
    blocks = b * hkv * chunks * q_tiles
    splits = 1
    if blocks < sms and t >= _SPLIT_FROM_KEYS:
        splits = max(1, min(2 * sms // blocks, t // _MIN_SPLIT_KEYS, _MAX_SPLITS))
    return {"heads_per_block": hpb, "positions_per_block": positions, "q_tiles": q_tiles,
            "splits": splits, "blocks": blocks * splits}


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """What the merge kernel computes, in plain PyTorch: partials of one row
    over splits along the last axis (acc (.., splits, D) unnormalised, m
    (.., splits) maxima in the log2 domain, l (.., splits) denominators)
    combine with weights exp2(m_s - max m)."""
    w = torch.exp2(m - m.amax(dim=-1, keepdim=True))
    return (acc * w[..., None]).sum(dim=-2) / (l * w).sum(dim=-1)[..., None]


def split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int,
                causal: bool = True, scale: float | None = None,
                q_offset: torch.Tensor | None = None,
                keys_per_tile: int = _KEYS_PER_TILE) -> torch.Tensor:
    """The kernel's split route in plain PyTorch, f32: every block of
    :func:`plan`'s ``positions_per_block`` query positions cuts its visible
    keys [0, kv_end) into tiles of ``keys_per_tile`` and gives each split an
    equal share of the tiles; the splits' (acc, m, l) are merged by
    :func:`merge_partials`. Equals :func:`flash_attention_plain` up to the
    order of the f32 sums."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qpos = plan(b, hq, hkv, s, t)["positions_per_block"]
    off = torch.zeros((b,), dtype=torch.int64) if q_offset is None else q_offset.to(torch.int64)
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, s, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, kf) * (scale * _LOG2E)
    rows = off[:, None] + torch.arange(s)                                  # (B, S)
    keys = torch.arange(t)
    visible = (keys[None, None, :] <= rows[:, :, None]) if causal \
        else torch.ones((b, s, t), dtype=torch.bool)
    logits = logits.masked_fill(~visible[:, None, None], -1e30)
    out = torch.empty((b, hkv, hq // hkv, s, d), dtype=torch.float32)
    for p0 in range(0, s, qpos):
        sl = slice(p0, min(s, p0 + qpos))
        for bi in range(b):
            kv_end = min(t, int(off[bi]) + sl.stop) if causal else t
            n_all = -(-kv_end // keys_per_tile)
            per = -(-n_all // splits)
            accs, ms, ls = [], [], []
            for sp in range(splits):
                lo, hi = sp * per * keys_per_tile, min(n_all, (sp + 1) * per) * keys_per_tile
                hi = min(hi, kv_end)
                lg = logits[bi, :, :, sl, lo:hi]                       # (Hkv, G, rows, keys)
                if hi <= lo:
                    m = torch.full(lg.shape[:-1], -float("inf"))
                    accs.append(torch.zeros(lg.shape[:-1] + (d,)))
                    ms.append(m)
                    ls.append(torch.zeros(lg.shape[:-1]))
                    continue
                m = lg.amax(dim=-1)
                p = torch.exp2(lg - m[..., None]) * visible[bi, sl, lo:hi][None, None]
                accs.append(torch.einsum("hgsk,hkd->hgsd", p, vf[bi, :, lo:hi]))
                ms.append(m)
                ls.append(p.sum(dim=-1))
            out[bi, :, :, sl] = merge_partials(torch.stack(accs, -2), torch.stack(ms, -1),
                                               torch.stack(ls, -1))
    return out.reshape(b, hq, s, d)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built flash-attention library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                           ctypes.c_float, i, i, i, p, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_geometry.argtypes = [p]
    lib.flash_attention_geometry.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    return bind(build.load("flash_attention"))


def geometry() -> dict:
    """The built kernel's tile: keys per tile, ring stages, heads per block
    at most, splits at most, rows per block."""
    out = (ctypes.c_int * 5)()
    _library().flash_attention_geometry(ctypes.addressof(out))
    return dict(zip(("keys_per_tile", "stages", "max_heads_per_block", "max_splits",
                     "rows_per_block"), out))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_strided(name: str, t: torch.Tensor):
    """The kernel moves 16 bytes (8 bf16) at a time along D."""
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be unit-stride on D, with strides that are multiples "
                         f"of 8 and a 16-byte aligned base; got strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None,
                         q_offset: torch.Tensor | None = None,
                         k_pos: torch.Tensor | None = None, window: int = 0, *,
                         splits: int | None = None,
                         plan_rows: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on bf16 CUDA tensors (k/v bf16 or
    float8_e4m3fn); raises on anything it does not take. q, k and v are read in place through their strides; the
    result is a (B, Hq, S, D) view of a (B, S, Hq, D) buffer, so a caller
    in the model's (B, S, H, D) layout transposes it back without a copy.
    Every query row must see at least one key (the kernel does not give the
    plain version's uniform average to a row that sees none).
    ``splits`` overrides :func:`plan`'s split count (for measurement);
    ``plan_rows`` plans for that many rows instead of B (a data shard of a
    slot grid plans as the whole grid, so its rows' bits are the unsharded
    grid's)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("q_offset", q_offset), ("k_pos", k_pos)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected (B, Hq, S, D) and two (B, Hkv, T, D)")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv or d not in HEAD_DIMS or s < 1 or t < 1:
        raise ValueError(f"unsupported flash attention: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"(D must be one of {HEAD_DIMS}, Hq a multiple of Hkv)")
    if q.dtype != torch.bfloat16 or k.dtype != v.dtype \
            or k.dtype not in (torch.bfloat16, torch.float8_e4m3fn):
        raise ValueError(f"the kernel takes bf16 q over a bf16 or float8_e4m3fn k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, x)
    check_local(causal, k_pos, window, b, t, dev)
    if k_pos is not None:
        k_pos = k_pos.contiguous()
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    if q_offset.dtype != torch.int32 or tuple(q_offset.shape) != (b,) \
            or not q_offset.is_contiguous():
        raise ValueError(f"q_offset must be a contiguous ({b},) int32 tensor")
    pl = plan(plan_rows or b, hq, hkv, s, t, sms=_sm_count(dev.index or 0))
    splits = pl["splits"] if splits is None else splits
    if not 1 <= splits <= _MAX_SPLITS:
        raise ValueError(f"splits must be 1-{_MAX_SPLITS}, got {splits}")
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if b == 0:
        return out
    ws_acc = ws_ml = None
    if splits > 1:
        ws_acc = torch.empty((b * hq * s * splits * d,), dtype=torch.float32, device=dev)
        ws_ml = torch.empty((b * hq * s * splits * 2,), dtype=torch.float32, device=dev)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(), ptr(k_pos),
        out.data_ptr(), ptr(ws_acc), ptr(ws_ml), b, hq, hkv, s, t, d, int(causal), int(window),
        float(scale),
        pl["heads_per_block"], splits, int(k.dtype == torch.float8_e4m3fn),
        ctypes.addressof(strides),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out
