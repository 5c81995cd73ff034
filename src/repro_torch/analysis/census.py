"""The structural record of one step-closure call (the port's counterpart of
the reference's ``analysis/hlo.py``).

The reference reads a jitted step's compiled HLO; PyTorch runs op by op,
so this module runs the closure once under two modes and records:

* every op's outputs (``TorchDispatchMode``): count by op, bytes by dtype,
  f64 outputs, and floating tensors computed from a packed FP4 leaf (its
  codes or scales) whose shape is that leaf's dense ``(K, N)`` or ``(E, K,
  N)`` or their transposes: a weight densified inside the step, recorded
  with the leaf's path;
* every read to the host: ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``float(t)``, ``bool(t)``) and ``Tensor.cpu``, ``.numpy``,
  ``.tolist`` (``TorchFunctionMode``: ``.tolist`` and ``.numpy`` of a CPU
  tensor reach no op); copies between devices; a tensor made from host data
  inside the step (``torch.tensor(...)``: on the card a copy from pageable
  memory, which synchronizes); and the ops whose output shape depends on
  the data (``nonzero``, ``masked_select``, ``unique``, ``bincount``, a
  boolean-mask index), which synchronize on the card;
* on CUDA tensors, a second witness: ``torch.cuda.set_sync_debug_mode``
  ("warn") around the call, whose warnings name every synchronizing CUDA
  call, those inside C++ ops included.

Each host read names the innermost frame of the port that made it.
"""
from __future__ import annotations

import dataclasses
import traceback
import warnings
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_PKG = str(Path(__file__).resolve().parents[1])
_ANALYSIS = str(Path(__file__).resolve().parent)
#: Tensor methods that read a tensor to the host
_HOST_METHODS = ("cpu", "numpy", "tolist", "item")
#: ops whose output shape depends on the data (a device-to-host read on the card)
_DATA_SHAPED = ("nonzero", "masked_select", "_unique2", "unique_consecutive", "unique_dim",
                "bincount")
_INDEX_OPS = ("index", "index_put", "index_put_", "_index_put_impl_")
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _where() -> str:
    """file:line of the innermost frame of the port outside its analysis."""
    for fr in reversed(traceback.extract_stack()):
        f = str(Path(fr.filename).resolve())
        if f.startswith(_PKG) and not f.startswith(_ANALYSIS):
            return f"{Path(f).relative_to(Path(_PKG).parent).as_posix()}:{fr.lineno}"
    return "?"


def packed_leaf_paths(tree, prefix: str = "") -> List[Tuple[str, dict]]:
    """``(path, leaf)`` for the packed FP4 linears of a param tree: every
    dict holding uint8 ``codes`` (and its ``scale``), its path joined by
    ``/`` (``layers/attn/wkv_b``)."""
    if isinstance(tree, dict):
        if isinstance(tree.get("codes"), torch.Tensor) and tree["codes"].dtype == torch.uint8:
            return [(prefix, tree)]
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [pl for k, v in items
            for pl in packed_leaf_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def packed_leaves(tree) -> List[dict]:
    """The packed FP4 linears of a param tree."""
    return [leaf for _, leaf in packed_leaf_paths(tree)]


def dense_shapes(leaf: dict) -> set:
    """The shapes a dequantized copy of one packed leaf takes: (K, N) per
    matrix (K with or without an odd-K pad row), (E, K, N) per expert stack,
    and the transposes."""
    c = leaf["codes"]
    k2, n = c.shape[-2], c.shape[-1]
    out = set()
    for k in (2 * k2, 2 * k2 - 1):
        out |= {(k, n), (n, k)}
        if c.dim() >= 3:
            e = c.shape[-3]
            out |= {(e, k, n), (e, n, k)}
    return out


@dataclasses.dataclass
class Census:
    ops: Counter = dataclasses.field(default_factory=Counter)
    out_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    host_reads: List[str] = dataclasses.field(default_factory=list)
    host_transfers: List[str] = dataclasses.field(default_factory=list)
    data_shaped: List[str] = dataclasses.field(default_factory=list)
    f64: List[str] = dataclasses.field(default_factory=list)
    #: (packed leaf's path, the op that densified it) pairs
    densified: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    sync_warnings: List[str] = dataclasses.field(default_factory=list)
    sync_witness: bool = False

    def stats(self) -> dict:
        return {"ops": sum(self.ops.values()), "out_bytes": sum(self.out_bytes.values()),
                "out_bytes_by_dtype": dict(self.out_bytes),
                "host_reads": len(self.host_reads), "host_transfers": len(self.host_transfers),
                "data_shaped_ops": len(self.data_shaped), "f64_outputs": len(self.f64),
                "densified": len(self.densified),
                "sync_warnings": len(self.sync_warnings) if self.sync_witness else None}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _OpMode(TorchDispatchMode):
    def __init__(self, census: Census, sources: Iterable[Tuple[str, set, List[torch.Tensor]]]):
        super().__init__()
        self.c = census
        # every tensor computed from a packed leaf, and that leaf's (path, dense shapes)
        self.taint: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
            weakref.WeakValueDictionary()
        self.source: Dict[int, Tuple[str, set]] = {}
        for path, shapes, tensors in sources:
            for t in tensors:
                self.taint[id(t)], self.source[id(t)] = t, (path, shapes)

    def _source(self, t: torch.Tensor):
        return self.source[id(t)] if self.taint.get(id(t)) is t else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        c = self.c
        c.ops[name] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name == "_local_scalar_dense":
            c.host_reads.append(f"a tensor read to a Python number @ {_where()}")
        elif name in ("_to_copy", "copy_", "lift_fresh", "lift_fresh_copy"):
            devs = {t.device for t in ins + outs}
            if len(devs) > 1:
                c.host_transfers.append(f"{name} across {sorted(map(str, devs))} @ {_where()}")
            elif name.startswith("lift_fresh"):
                c.host_transfers.append(f"a tensor made from host data ({name}) @ {_where()}")
        elif name in _DATA_SHAPED or (name == "repeat_interleave"
                                      and "Tensor" in func._overloadname
                                      and kwargs.get("output_size") is None):
            c.data_shaped.append(f"{name} @ {_where()}")
        elif name in _INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices")
            if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in (idx or ())):
                c.data_shaped.append(f"{name} with a boolean mask @ {_where()}")
        src = next((s for s in map(self._source, ins) if s is not None), None)
        for t in outs:
            key = str(t.dtype).replace("torch.", "")
            c.out_bytes[key] = c.out_bytes.get(key, 0) + t.numel() * t.element_size()
            if t.dtype in (torch.float64, torch.complex128):
                c.f64.append(f"{name} -> {tuple(t.shape)} {key} @ {_where()}")
            if src is not None:
                self.taint[id(t)], self.source[id(t)] = t, src
                if t.dtype in _FLOATS and tuple(t.shape) in src[1]:
                    c.densified.append(
                        (src[0], f"{name} -> {tuple(t.shape)} {key} @ {_where()}"))
        return out


class _HostMode(TorchFunctionMode):
    def __init__(self, census: Census):
        super().__init__()
        self.c = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in _HOST_METHODS and func.__name__ != "item":
            self.c.host_reads.append(f".{func.__name__}() @ {_where()}")
        return func(*args, **(kwargs or {}))


def record(fn: Callable, args: Tuple[Any, ...], params=None) -> Tuple[Any, Census]:
    """Call ``fn(*args)`` once and return its output and census. ``params``
    (a param tree; by default none) names the packed leaves whose densified
    copies are recorded."""
    sources = [(path, dense_shapes(leaf),
                [t for t in (leaf["codes"], leaf.get("scale")) if isinstance(t, torch.Tensor)])
               for path, leaf in (packed_leaf_paths(params) if params is not None else [])]
    c = Census()
    on_card = any(t.is_cuda for t in _tensors(args))
    c.sync_witness = on_card
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode() if on_card else None
        if on_card:
            # lint: allow[torch-global-state] — the second witness; restored below
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with _HostMode(c), _OpMode(c, sources):
                out = fn(*args)
        finally:
            if on_card:
                # lint: allow[torch-global-state] — restores the caller's mode
                torch.cuda.set_sync_debug_mode(prev)
    c.sync_warnings = [str(w.message) for w in caught
                       if "called a synchronizing CUDA operation" in str(w.message)]
    return out, c
