"""The benchmark's weights: drawn on the device from the run's seed.

The tree is the port's serving tree (its leaves' names, shapes and dtypes
are read from the model's ``init_params`` on the ``meta`` device, which
draws nothing); every value is the benchmark's own, made in a few large
calls on one ``torch.Generator``:

* FP4 linears ``{"codes", "scale"[, "b"]}``: packed E2M1 nibbles, uniform
  over the 16 codes (one ``randint`` over every linear's bytes at once),
  and per-column f32 scales that give each column an RMS of about
  ``1/sqrt(d_in)``; biases f32;
* norm scales f32 about 1, the bf16 embedding table;
* the leaves only a family has (MoE routers), as its file in
  ``servebench/families/`` draws them.

The engine and the reference get these same tensors.
"""
from __future__ import annotations

import math

import torch

from servebench import families

#: RMS of the 16 E2M1 values, each code equally likely
_E2M1_RMS = math.sqrt(sum(v * v for v in (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)) / 8)


def _randn(gen, n, device):
    return torch.randn((n,), generator=gen, device=device)


def _codes(gen, n, device):
    return torch.randint(0, 256, (n,), generator=gen, device=device, dtype=torch.uint8)


def _fp4_scale(gen, n, device):
    return torch.rand((n,), generator=gen, device=device) * 0.5 + 0.75


def _column_rms(v, meta, parent):
    return v / (_E2M1_RMS * math.sqrt(2 * parent["codes"].shape[-2]))


#: the leaves every family has: kind -> (a flat draw of n values, and what
#: makes a leaf's cut of it its values, given the leaf's meta tensor and
#: its parent's meta tree; None: the cut as it is)
COMMON = {
    "codes": (_codes, None),
    "fp4_scale": (_fp4_scale, _column_rms),
    "bias": (lambda gen, n, device: _randn(gen, n, device) * 0.1, None),
    "norm": (lambda gen, n, device: _randn(gen, n, device) * 0.1 + 1.0, None),
    "embed": (_randn, None),
}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


def _kind(tree, path, own: dict) -> str:
    """What a leaf holds, by its name and its siblings; ``own`` is the
    family's ``LEAVES``."""
    name = path[-1]
    if name == "codes":
        return "codes"
    if name == "scale":
        return "fp4_scale" if "codes" in _get(tree, path[:-1]) else "norm"
    if name == "b":
        return "bias"
    if name == "table":
        return "embed"
    if name in own:
        return own[name][0]
    raise ValueError(f"no rule draws the leaf {'/'.join(map(str, path))}")


def draw(shapes, seed: int, device, family: str) -> dict:
    """Values for every leaf of ``shapes`` (a tree of meta tensors) of a
    model of ``family``, on ``device``, from ``seed``. Leaves of one kind
    are cut from one draw, the kinds in the order of their names."""
    own = families.load(family).LEAVES
    rules = dict(COMMON, **{kind: (fn, cut) for kind, fn, cut in own.values()})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    by_kind: dict = {}
    for p, t in _leaves(shapes):
        by_kind.setdefault(_kind(shapes, p, own), []).append((p, t))
    out = _copy_structure(shapes)
    for kind in sorted(by_kind):
        items = by_kind[kind]
        fn, cut = rules[kind]
        flat = fn(gen, sum(t.numel() for _, t in items), device)
        at = 0
        for p, t in items:
            v = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
            if cut is not None:
                v = cut(v, t, _get(shapes, p[:-1]))
            _set(out, p, v.to(t.dtype))
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None
