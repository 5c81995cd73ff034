"""CREST -- Cyclic REdundant Spare Testing (paper Sections 3.4, 20, 21), in PyTorch.

The paper's runtime fault tolerance: spare CASCADE columns recompute a
cyclically rotating subset of live output columns with identical inputs and
copied weights; outputs are compared, ``threshold`` consecutive mismatches
confirm a fault (filtering cosmic-ray transients), and the faulty column is
remapped to a spare with zero throughput loss (paper: 16 spares per 8,208
columns). A ``CrestState`` tracks, per protected matmul:

* the cyclic test cursor (the first live column under shadow computation),
* consecutive-mismatch counters (cosmic-ray filtering, paper Section 20.2),
* the spare-slot assignment table (live column -> spare slot), applied
  every step, so a confirmed-faulty column is permanently served by spare
  recomputation (the paper's Figure 10f repair).

The overhead is 2 * n_spares extra output columns a matmul (test copies and
repair copies), however many faults exist. Fault injection corrupts the live
output of chosen columns; the spare path computes from the pristine weights.

The state is integer work on device tensors, the reference's
(``src/repro/core/crest.py``) step by step, so it equals the reference's
exactly on the same inputs; ``crest_matmul`` makes no host sync. Its
products are dense f32 ``torch.matmul``s (the reference's ``jnp.dot``,
outside any kernel), run in full f32 whatever the caller's TF32 setting:
the compare tolerance (1e-4 relative) is below TF32's rounding.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CrestConfig:
    n_spares: int = 16          # spare columns per array (paper: 16/8208)
    threshold: int = 3          # consecutive mismatches to confirm (Section 20.2)
    tol: float = 1e-4           # relative compare: the live (M, N) and spare (M, ns)
                                # products may reduce in different orders


class CrestState(NamedTuple):
    cursor: torch.Tensor            # () int32: first live column under test
    mismatch_count: torch.Tensor    # (n_cols,) int32 consecutive-mismatch counters
    spare_assign: torch.Tensor      # (n_spares,) int32 column repaired by this slot, -1 = free
    confirmed_faults: torch.Tensor  # (n_cols,) bool
    n_repaired: torch.Tensor        # () int32


def crest_init(n_cols: int, cfg: CrestConfig, device=None) -> CrestState:
    i32 = dict(dtype=torch.int32, device=device)
    return CrestState(
        cursor=torch.zeros((), **i32),
        mismatch_count=torch.zeros((n_cols,), **i32),
        spare_assign=torch.full((cfg.n_spares,), -1, **i32),
        confirmed_faults=torch.zeros((n_cols,), dtype=torch.bool, device=device),
        n_repaired=torch.zeros((), **i32),
    )


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside, the caller's setting after."""
    prev = torch.get_float32_matmul_precision()
    # lint: allow[torch-global-state] — scoped: the caller's setting is restored below
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        # lint: allow[torch-global-state] — restores the caller's setting
        torch.set_float32_matmul_precision(prev)


def allocate_spares(spare_assign: torch.Tensor, newly: torch.Tensor,
                    test_cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's allocation scan, vectorised: the i-th newly confirmed
    test column, in order of i, takes the lowest free slot, while a free slot
    is left. Each pick takes the lowest free slot and only free slots are
    filled, so the k-th allocation lands on the k-th lowest slot free at the
    start: test column i takes free slot ``rank_i`` (the newly confirmed
    before it) if ``rank_i`` < the free count. Returns (new assignment,
    allocated (ns,) bool)."""
    ns = spare_assign.shape[0]
    free = spare_assign == -1
    rank = torch.cumsum(newly.to(torch.int32), 0) - 1
    can = newly & (rank < free.sum())
    # the free slots in ascending order first (a stable sort of "taken")
    free_slots = torch.sort((~free).to(torch.int8), stable=True).indices
    target = torch.where(can, free_slots[rank.clamp(0, ns - 1)], ns)   # ns: dropped
    out = torch.cat([spare_assign, spare_assign.new_full((1,), -1)])
    out.scatter_(0, target.to(torch.int64), test_cols.to(out.dtype))
    return out[:ns], can


def crest_matmul(x: torch.Tensor, w: torch.Tensor, state: CrestState, cfg: CrestConfig,
                 fault_mask: torch.Tensor | None = None) -> Tuple[torch.Tensor, CrestState]:
    """One CREST-protected matmul step. x: (M, K); w: (K, N). Returns y
    (M, N) in x's dtype and the new state (the old one is not modified)."""
    n = w.shape[1]
    ns = cfg.n_spares
    test_cols = ((state.cursor + torch.arange(ns, dtype=torch.int32, device=w.device)) % n
                 ).to(torch.int64)
    xf, wf = x.to(torch.float32), w.to(torch.float32)

    with full_f32_matmul():
        y_live = torch.matmul(xf, wf)
        if fault_mask is not None:
            y_live = y_live + torch.where(fault_mask[None, :], 7.0 + y_live * 0.5, 0.0)
        # --- cyclic testing: spare columns recompute the columns under test ---
        y_spare = torch.matmul(xf, wf.index_select(1, test_cols))        # (M, ns)
    y_tested = y_live.index_select(1, test_cols)                          # (M, ns)
    mismatch = torch.any((y_tested - y_spare).abs() > cfg.tol * (1.0 + y_spare.abs()), dim=0)

    count = torch.where(mismatch, state.mismatch_count[test_cols] + 1, 0).to(torch.int32)
    newly = (count >= cfg.threshold) & ~state.confirmed_faults[test_cols]
    confirmed = state.confirmed_faults.clone()
    confirmed[test_cols] = state.confirmed_faults[test_cols] | newly

    # --- allocate free spare slots to newly confirmed columns ---
    spare_assign, allocated = allocate_spares(state.spare_assign, newly, test_cols)

    # --- substitute spare recomputation for tested columns that just confirmed ---
    y = y_live.clone()
    y[:, test_cols] = torch.where(newly[None, :], y_spare, y_tested)

    # --- permanent repair path: recompute all spare-assigned columns ---
    assigned = spare_assign >= 0
    repair_cols = torch.where(assigned, spare_assign, 0).to(torch.int64)
    with full_f32_matmul():
        y_rep = torch.matmul(xf, wf.index_select(1, repair_cols))        # (M, ns)
    scatter_idx = torch.where(assigned, spare_assign, n).to(torch.int64)  # n: dropped
    slot_of_col = torch.zeros((n + 1,), dtype=torch.int64, device=w.device).scatter_(
        0, scatter_idx, torch.arange(ns, device=w.device))[:n]
    use_repair = torch.zeros((n + 1,), dtype=torch.bool, device=w.device).scatter_(
        0, scatter_idx, torch.ones((ns,), dtype=torch.bool, device=w.device))[:n]
    y = torch.where(use_repair[None, :], y_rep.index_select(1, slot_of_col), y)

    mismatch_count = state.mismatch_count.clone()
    mismatch_count[test_cols] = torch.where(newly, 0, count).to(torch.int32)
    new_state = CrestState(
        cursor=((state.cursor + ns) % n).to(torch.int32),
        mismatch_count=mismatch_count,
        spare_assign=spare_assign,
        confirmed_faults=confirmed,
        n_repaired=(state.n_repaired + allocated.sum()).to(torch.int32),
    )
    return y.to(x.dtype), new_state


def inject_column_faults(gen: torch.Generator, n_cols: int, n_faults: int) -> torch.Tensor:
    """Boolean (n_cols,) mask with ``n_faults`` defective columns, drawn
    without replacement from ``gen`` (on the generator's device). Torch's
    generator gives other columns than the reference's threefry key."""
    idx = torch.randperm(n_cols, generator=gen, device=gen.device)[:n_faults]
    return torch.zeros((n_cols,), dtype=torch.bool, device=gen.device).index_fill_(0, idx, True)


def coverage_stats(state: CrestState, fault_mask: torch.Tensor) -> dict:
    return {
        "injected": int(fault_mask.sum()),
        "detected": int((state.confirmed_faults & fault_mask).sum()),
        "false_positives": int((state.confirmed_faults & ~fault_mask).sum()),
        "repaired": int(state.n_repaired),
    }
