"""Decode attention: the Hopper CUDA kernel's launcher and its plain version.

One query token per slot against one layer's stacked cache: q (B, Hq, D),
k/v (B, T, Hkv, D); GQA maps q head h to kv head h // (Hq / Hkv). Key t of
row b is live iff ``t <= q_pos[b]`` (when ``q_pos``, a (B,) int32 tensor, is
given; at or past T every row is live, as the reference's clamped write
index) and ``mask[b, t]`` is nonzero (when a (B, T) mask is given). Scores
are scaled, set to -1e30 where dead, soft-maxed over T and contracted with
v, all in f32; a row with no live key averages v uniformly over T. The
result is (B, Hq, D) f32. Asked (``return_lse``), each row's log-sum-exp of
its live scaled scores comes beside it, (B, Hq) f32, -inf where no key is
live (the output there is still v's average): a caller holding one band of
a cache's T merges the bands' outputs with it. An FP8 cache (k/v
``float8_e4m3fn``, q bf16) is read as it lies; the plain version upcasts
it, and the kernel's result is its result on the cache upcast to bf16, bit
for bit. The kernel is ``csrc/decode_attention.cu``; it
replaces the TPU kernel ``decode_attention_pallas`` in the JAX package's
``kernels/flash_attention.py``. ``kernels.ops.decode_attention`` is the
wrapper callers use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_MAX_D = 256
_MAX_HEADS = 8        # query heads one block holds (a larger group takes several)
_MAX_SPLITS = 32
_MIN_SPLIT_KEYS = 256  # T is split only into pieces of at least this many rows


def check_q_pos(q_pos: torch.Tensor | None, batch: int, device) -> None:
    """Raise unless ``q_pos`` is absent or a (batch,) int32 tensor on ``device``."""
    if q_pos is None:
        return
    if q_pos.device != device:
        raise ValueError(f"q_pos is on {q_pos.device}, q on {device}")
    if q_pos.dtype != torch.int32 or tuple(q_pos.shape) != (batch,):
        raise ValueError(f"q_pos must be ({batch},) int32, got {tuple(q_pos.shape)} "
                         f"{q_pos.dtype}")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor | None = None, scale: float | None = None,
                           q_pos: torch.Tensor | None = None, return_lse: bool = False):
    """Plain PyTorch version of the kernel (the reference's masked softmax);
    with ``return_lse``, (out, lse) as the kernel gives them."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    check_q_pos(q_pos, b, q.device)
    live = torch.ones((b, t), dtype=torch.bool, device=q.device) if mask is None else mask != 0
    if q_pos is not None:
        live = live & (torch.arange(t, device=q.device)[None, :] <= q_pos[:, None])
    qd = q.to(torch.float32).reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qd, k.to(torch.float32)) * scale
    logits = logits.masked_fill(~live[:, None, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32)).reshape(b, hq, d)
    if not return_lse:
        return o
    dead = torch.full((), float("-inf"), device=q.device)
    lse = torch.logsumexp(torch.where(live[:, None, None, None, :], logits, dead), dim=-1)
    return o, lse.reshape(b, hq)


def kernel_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The kernel's dtype code: q/k/v all f32 (0) or all bf16 (1), or bf16 q
    over an e4m3 cache (2); ``ValueError`` for any other mix."""
    if k.dtype == v.dtype == q.dtype and q.dtype in (torch.float32, torch.bfloat16):
        return int(q.dtype == torch.bfloat16)
    if q.dtype == torch.bfloat16 and k.dtype == v.dtype == torch.float8_e4m3fn:
        return 2
    raise ValueError(f"q/k/v must share bf16 or f32, or be bf16 q over a float8_e4m3fn "
                     f"cache, got {q.dtype}/{k.dtype}/{v.dtype}")


def heads_per_block(group: int) -> int:
    """Query heads one block holds: the whole group up to 8, else the group
    cut into the fewest equal chunks of at most 8."""
    return -(-group // -(-group // _MAX_HEADS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def choose_splits(b: int, hkv: int, group: int, t: int, sms: int = 132) -> int:
    """Blocks along T, from the shapes alone (never from q_pos, so that the
    call does not sync): about 16 blocks an SM (measured best at T = 4096
    on an H100, where few, long blocks leave the last wave's SMs idle), each
    split at least ``_MIN_SPLIT_KEYS`` rows of T, so a short cache (the
    served step) keeps one split and no merge launch."""
    blocks = b * hkv * -(-group // heads_per_block(group))
    return max(1, min(-(-16 * sms // max(blocks, 1)), t // _MIN_SPLIT_KEYS, _MAX_SPLITS))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built decode-attention library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                            ctypes.c_float, p, i, p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_geometry.argtypes = [p]
    lib.decode_attention_geometry.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded at first use."""
    return bind(build.load("decode_attention"))


def geometry() -> dict:
    """The built kernel's tile: keys per tile, ring stages, heads per block
    at most, splits at most."""
    out = (ctypes.c_int * 4)()
    _library().decode_attention_geometry(ctypes.addressof(out))
    return dict(zip(("keys_per_tile", "stages", "max_heads_per_block", "max_splits"), out))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None, scale: float | None = None,
                          q_pos: torch.Tensor | None = None, *,
                          splits: int | None = None,
                          plan_rows: int | None = None, return_lse: bool = False):
    """Launch the CUDA kernel; k/v are read in place through their strides.
    ``splits`` overrides :func:`choose_splits` (for measurement);
    ``plan_rows`` chooses them for that many rows instead of B (a data
    shard of a slot grid plans as the whole grid, so its rows' bits are the
    unsharded grid's); ``return_lse`` returns (out, lse), out with the bits
    of the call without it."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    for name, x in (("k", k), ("v", v), ("mask", mask)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if hq % hkv or d > _MAX_D or t < 1 or (mask is not None and tuple(mask.shape) != (b, t)):
        raise ValueError(f"unsupported decode attention: Hq={hq} Hkv={hkv} D={d} T={t} "
                         f"mask {None if mask is None else tuple(mask.shape)}")
    check_q_pos(q_pos, b, dev)
    dtypes = kernel_dtypes(q, k, v)
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q must be contiguous and k/v unit-stride on D")
    esize = k.element_size()
    strides = [k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2)]
    if (d * esize) % 16 or any((s * esize) % 16 for s in strides) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel loads 16-byte pieces: D and the k/v strides must be "
                         "multiples of 16 bytes and k/v 16-byte aligned")
    group = hq // hkv
    hpb = heads_per_block(group)
    if splits is None:
        splits = choose_splits(plan_rows or b, hkv, group, t, _sm_count(dev.index or 0))
    if not 1 <= splits <= _MAX_SPLITS:
        raise ValueError(f"splits must be 1-{_MAX_SPLITS}, got {splits}")
    live = None
    if mask is not None:
        live = (mask if mask.dtype == torch.bool else mask != 0).contiguous().view(torch.uint8)
    pos = None if q_pos is None else q_pos.contiguous()
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq), dtype=torch.float32, device=dev) if return_lse else None
    if b == 0:
        return (out, lse) if return_lse else out
    ws_acc = ws_ml = None
    if splits > 1:
        ws_acc = torch.empty((b * hq * splits * d,), dtype=torch.float32, device=dev)
        ws_ml = torch.empty((b * hq * splits * 2,), dtype=torch.float32, device=dev)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    st = (ctypes.c_longlong * 6)(*strides)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(live), ptr(pos), out.data_ptr(), ptr(lse),
        ptr(ws_acc), ptr(ws_ml), b, hq, hkv, t, d, hpb, splits, float(scale),
        ctypes.addressof(st), dtypes,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    return (out, lse) if return_lse else out
