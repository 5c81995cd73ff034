"""AdamW over the port's nested param trees, with the reference's
arithmetic (``repro/optim/adamw.py``): a global-norm gradient clip, bias
corrections, a warmup-then-cosine learning rate, and weight decay on every
leaf of two or more dims. ``torch.optim.AdamW`` is not used: its clip,
schedule and decay mask are not the reference's.

The decay mask is the reference's, quirk and all: it means to skip norms
and biases, but the layers' leaves are stacked ``(L, d)``, so a stacked
norm scale or bias (``layers/ln1/scale``, ``layers/attn/wq/b``) has two
dims and is decayed; only an unstacked one (``final_norm/scale``) is not.

The update is in place: the params and the moment trees are overwritten
(the reference returns new trees), and a large leaf is updated in pieces
along its first axis (whole layers of a stacked leaf, row blocks of an
embedding) of at most ``PIECE`` elements, so the f32 temporaries of a
full-width model stay a few hundred MB. The arithmetic is elementwise, so
neither changes a bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T

#: the most elements of a leaf updated at once (f32 temporaries of 256 MB)
PIECE = 1 << 26


def _div(a, b) -> torch.Tensor:
    """``a / b`` in f32 as one IEEE division, a Python number made a tensor
    first: torch divides by (or into) a Python number through a reciprocal,
    which rounds twice."""
    t = a if isinstance(a, torch.Tensor) else b
    as_t = lambda v: (v.to(torch.float32) if isinstance(v, torch.Tensor)
                      else torch.full((), float(v), device=t.device))
    return as_t(a) / as_t(b)


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_frac: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda t: T.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)
        dev = T.leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=zeros(params), nu=zeros(params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (an int tensor), in f32."""
        warm = torch.clamp(_div(step, max(self.warmup_steps, 1)), max=1.0)
        prog = torch.clamp(_div(step - self.warmup_steps, max(self.decay_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (self.min_lr_frac + (1 - self.min_lr_frac) * cos)

    def _update_leaf(self, g, m, v, p, clip, lr, b1c, b2c, decay: bool) -> None:
        """One leaf (or one layer of a stacked leaf), in place."""
        g = g.to(torch.float32) * clip
        m.copy_(self.b1 * m + (1 - self.b1) * g)
        v.copy_(self.b2 * v + (1 - self.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
        pf = p.to(torch.float32)
        if decay:
            delta = delta + self.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, grad_sq=None, param_view=None):
        """One step: returns (params, new state, {"gnorm", "lr"}); ``params``
        and the state's ``mu``/``nu`` are the trees passed in, updated in
        place. ``grad_sq`` maps the flat gradients to their global sum of
        squares (a mesh's: the banded leaves' summed over the ranks that
        hold their bands); by default the sum over the leaves given.
        ``param_view(i, p)`` is the part of flat param ``i`` the update
        writes (ZeRO-1: the rank's data band, of the gradient's and the
        moments' shape); by default the whole param."""
        step = state.step + 1
        flat_g, flat_p = T.leaves(grads), T.leaves(params)
        flat_m, flat_v = T.leaves(state.mu), T.leaves(state.nu)
        if grad_sq is not None:
            sq = grad_sq(flat_g)
        else:
            sq = 0
            for g in flat_g:
                sq = sq + torch.sum(g.to(torch.float32) ** 2)
        gnorm = torch.sqrt(sq + 1e-12)
        clip = torch.clamp(_div(self.grad_clip, gnorm), max=1.0)
        lr = self.schedule(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(torch.full_like(stepf, self.b1), stepf)
        b2c = 1 - torch.pow(torch.full_like(stepf, self.b2), stepf)
        for i, (g, m, v, p) in enumerate(zip(flat_g, flat_m, flat_v, flat_p)):
            if param_view is not None:
                p = param_view(i, p)
            decay = p.dim() >= 2            # the reference's mask (see the module doc)
            if p.dim() and p.numel() > PIECE:
                rows = max(1, PIECE // (p.numel() // p.shape[0]))
                for i in range(0, p.shape[0], rows):
                    sl = slice(i, i + rows)
                    self._update_leaf(g[sl], m[sl], v[sl], p[sl], clip, lr, b1c, b2c, decay)
            else:
                self._update_leaf(g, m, v, p, clip, lr, b1c, b2c, decay)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"gnorm": gnorm,
                                                                          "lr": lr}
