"""Checkpoint and restart (the reference's ``repro/train/checkpoint.py``,
its on-disk format): each leaf one ``.npy`` under ``step_N/``, with a JSON
manifest of leaf names, files, shapes and dtypes and an ``extra`` dict (the
data cursor). The leaf names are the reference's (``.params/embed/table``,
``.opt/.mu/layers/...``, ``.step``: ``repro_torch.tree``'s paths), so each
side restores the other's checkpoints of f32 and integer leaves.

* async save: the leaves are copied to the host first, then a thread
  writes them, and training goes on;
* atomic publish: the files go to ``step_N.tmp/`` and the directory is
  renamed to ``step_N`` after the manifest is fsynced, so a crash mid-save
  never leaves a half-written newest step; ``latest_step`` sees complete
  steps only.

numpy has no bfloat16 (the card's machine has no ``ml_dtypes``), so a bf16
leaf is written as its uint16 bits with ``"dtype": "bfloat16"`` in the
manifest, and read back as those bits. The reference cannot read such a
leaf (it ``astype``s the stored values, not their bits).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _names(tree: Any):
    return [("/".join(path), leaf) for path, leaf in T.leaves_with_paths(tree)]


def _to_host(t) -> np.ndarray:
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16)
    return t.cpu().numpy()


def save(tree: Any, directory: str, step: int, extra: Optional[dict] = None,
         async_: bool = False) -> Optional[threading.Thread]:
    """Snapshot ``tree`` to the host and write it to ``directory/step_{step}``;
    with ``async_`` the writing runs on a thread, which is returned."""
    named = [(name, _to_host(leaf), torch.as_tensor(leaf).dtype == torch.bfloat16)
             for name, leaf in _names(tree)]

    def _write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (name, arr, bf16) in enumerate(named):
            fn = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({"name": name, "file": fn, "shape": list(arr.shape),
                                       "dtype": "bfloat16" if bf16 else str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(tree_like: Any, directory: str, step: Optional[int] = None) -> tuple[Any, dict]:
    """Leaves of ``tree_like``'s names, shapes, dtypes and devices from
    ``directory/step_{step}`` (the newest complete step when None). Returns
    (tree, extra). A leaf that requires grad in ``tree_like`` does so in the
    tree returned."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name, like in _names(tree_like):
        e = by_name[name]
        arr = np.load(os.path.join(d, e["file"]))
        if e["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))        # a writable copy, 0-d kept
        like = torch.as_tensor(like)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: stored shape {tuple(t.shape)}, expected "
                             f"{tuple(like.shape)}")
        t = t.to(device=like.device, dtype=like.dtype)
        out.append(t.requires_grad_(like.requires_grad))
    return T.unflatten_like(tree_like, out), manifest["extra"]
