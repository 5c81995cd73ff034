"""The serving contract, applied to every step closure of an engine.

``ServingContract`` declares what one call of a serving step may do (the
reference's ``repro/analysis/contract.py``, held to the census of a call,
``analysis/census.py``, where the reference reads compiled HLO):

* no read to the host inside a closure (a step is work queued on the card;
  the engine's one read, the step's tokens, follows its closures);
* the cache updated in place, the counterpart of donation: every cache leaf
  of at least ``donation_min_bytes`` keeps its storage across each closure
  in ``strict_donation_closures`` (a reallocated leaf keeps two copies of
  the KV live); ``extend`` and ``rewind`` are best-effort, as in the
  reference;
* no forbidden dtype (f64), and packed (uint8 codes) weight params on the
  ``serve_fp4`` path;
* no weight densified inside a step: a floating tensor computed from a
  packed leaf in that leaf's dense shape. On the kernel route this gates,
  one finding a leaf (``closure:leaf/path``);
  on the plain route (CPU tensors, where every linear dequantizes by
  design) it is an info finding, as the reference treats interpret mode;
* the collective budget: on a mesh engine, each closure's counted
  collectives (``engine.collectives``, ``distributed/collectives.py``: the
  port's counterpart of the reference's HLO collective stats) held to
  ``max_partial_sum_allreduces`` -- 0 under the cascade placement,
  uncapped under megatron -- except the ``psum_exempt_closures``, as in the
  reference; with no mesh, an info finding. On a mesh every rank audits
  (each closure's collectives need all the ranks).

``audit_engine(engine)`` calls every closure of ``engine.step_closures()``
once, on a copy of the engine's cache (the engine's own cache, sampling
generator and verify checkpoint are left as they were), and returns the
findings with per-closure stats.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.analysis import census
from repro_torch.analysis.findings import Finding
from repro_torch.distributed import collectives


@dataclasses.dataclass(frozen=True)
class ServingContract:
    """What one call of a serving step is allowed to do, beyond what every
    step is held to (no host read, no f64)."""
    # leaves smaller than this are advisory for the in-place check
    donation_min_bytes: int = 1024
    # closures whose cache update is in place by construction, where every
    # major leaf MUST keep its storage; extend (a staging cache's first
    # chunk) and rewind are best-effort, as in the reference
    strict_donation_closures: Tuple[str, ...] = (
        "decode", "sample", "write", "verify", "spec_sample", "copy_page", "reset_pos")
    require_packed_weights: bool = False
    # the zero-partial-sum claim (paper 2.2/13.5) covers the decode-path
    # closures; None: uncapped (the megatron baseline)
    max_partial_sum_allreduces: Optional[int] = 0
    # closures the partial-sum cap skips, as the reference's contract has
    # it (its chunked prefill writes a batch-1 staging cache under a
    # replicated placement)
    psum_exempt_closures: Tuple[str, ...] = ("extend",)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_contract(engine) -> ServingContract:
    """The contract the engine's configuration promises: packed weights iff
    it serves FP4, zero partial-sum all-reduces iff the cascade policy
    placed the params (megatron is the measured baseline that has them)."""
    return ServingContract(
        require_packed_weights=(engine.ccfg.mode == "serve_fp4"),
        max_partial_sum_allreduces=0 if getattr(engine, "tp_policy", "cascade") == "cascade"
        else None)


def _leaves(cache) -> list:
    return [(p, t) for p, t in T.leaves_with_paths(cache) if isinstance(t, torch.Tensor)]


def _cache_out(out, index):
    if index is None:
        return None
    return out if index == -1 else out[index]


def audit_step(name: str, fn, args: tuple, contract: ServingContract, *, params=None,
               takes_params: bool = True, cache_arg: Optional[int] = None,
               cache_out: Optional[int] = None, kernel_route: bool = False) -> Tuple[dict, list]:
    """Call one step closure ``fn(*args)`` under the census and hold it to
    the contract. ``cache_arg``/``cache_out``: the cache's index among the
    arguments and outputs (-1: the output is the cache; None: no cache).
    ``params``: the tree whose packed leaves are watched for densified
    copies. ``kernel_route``: the closure runs the CUDA kernels, so a
    densified weight gates. Returns ``(stats, findings)``."""
    findings = []
    cache_in = args[cache_arg] if cache_arg is not None else None
    before = {p: (t.untyped_storage().data_ptr(), t.numel() * t.element_size())
              for p, t in _leaves(cache_in)} if cache_in is not None else {}
    out, c = census.record(fn, args, params=params)
    stats = {**c.stats(), "ops_by_name": dict(c.ops.most_common(8))}
    if cache_in is not None:
        after = dict(_leaves(_cache_out(out, cache_out)))
        major = [p for p, (_, nbytes) in before.items() if nbytes >= contract.donation_min_bytes]
        moved = [p for p in major if p not in after
                 or after[p].untyped_storage().data_ptr() != before[p][0]]
        stats.update(cache_leaves=len(before), cache_major_leaves=len(major),
                     cache_leaves_in_place=len(major) - len(moved))
        if moved and name in contract.strict_donation_closures:
            findings.append(Finding(
                "in-place-cache", name,
                f"{len(moved)}/{len(major)} cache leaves >= {contract.donation_min_bytes}B "
                f"were reallocated ({'/'.join(moved[0])} first) — a step keeps the old and "
                f"the new cache live (2x KV memory)"))
    for what in c.host_reads + c.host_transfers + c.data_shaped:
        findings.append(Finding(
            "host-read", f"{name}:{what.rsplit(' @ ', 1)[-1]}",
            f"{what.rsplit(' @ ', 1)[0]} inside a serving step — the step must queue its "
            f"work on the device and read the host once, after its closures"))
    if c.sync_witness and c.sync_warnings:
        findings.append(Finding(
            "host-read", name,
            f"torch.cuda.set_sync_debug_mode saw {len(c.sync_warnings)} synchronizing "
            f"CUDA call(s): {c.sync_warnings[0]}"))
    if c.f64:
        findings.append(Finding("dtype", name, f"forbidden dtype in a serving step: "
                                f"{len(c.f64)} f64 output(s) (first: {c.f64[0]})"))
    if takes_params:
        packed = len(census.packed_leaves(params)) if params is not None else 0
        stats["packed_params"] = packed
        stats["float_params"] = sum(1 for t in T.leaves(params or {})
                                    if isinstance(t, torch.Tensor) and t.is_floating_point())
        if contract.require_packed_weights and packed == 0:
            findings.append(Finding(
                "dtype", name,
                "no packed (uint8 codes) weight parameter in a serve_fp4 step — the weight "
                "tree was densified before dispatch"))
    if c.densified and kernel_route:
        by_leaf = {}
        for leaf, what in c.densified:
            by_leaf.setdefault(leaf, []).append(what)
        for leaf, whats in by_leaf.items():
            findings.append(Finding(
                "densified-weight", f"{name}:{leaf}",
                f"{len(whats)} floating tensor(s) in the dense shape of packed leaf {leaf} "
                f"were computed from its codes inside the step (first: {whats[0]})"))
    elif c.densified:
        findings.append(Finding(
            "densified-weight", name,
            f"{len(c.densified)} floating tensor(s) in the dense shape of "
            f"{len({leaf for leaf, _ in c.densified})} packed leaves were computed from their "
            f"codes inside the step (first: {c.densified[0][0]}: {c.densified[0][1]}) — the "
            f"plain route dequantizes every linear by design; checked on the kernel route",
            level="info"))
    return stats, findings


def collective_budget(name: str, counts: dict, contract: ServingContract,
                      stats: dict) -> list:
    """Hold one closure's counted collectives (a ``collectives.since``
    record) to the partial-sum cap; adds them to ``stats``."""
    psum = collectives.partial_sum_allreduces(counts)
    stats.update(collectives={k: counts[k] for k in collectives.KINDS},
                 partial_sum_allreduces=psum,
                 collective_bytes=sum(counts[k]["bytes"] for k in collectives.KINDS))
    cap = contract.max_partial_sum_allreduces
    if cap is None or name in contract.psum_exempt_closures or psum <= cap:
        return []
    return [Finding("collective-budget", name,
                    f"{psum} partial-sum all-reduce(s) ({counts['all_reduce_sum']['bytes']} B) "
                    f"in one call, over the contract's {cap}: a SUM of partial products "
                    "crossed ranks (paper Sections 2.2, 13.5)")]


def audit_engine(engine, contract: Optional[ServingContract] = None) -> dict:
    """Call and audit every step closure of a constructed engine.

    Returns ``{"contract", "closures": {name: stats}, "findings"}`` with
    ``findings`` a list of ``Finding``. The caller decides gating
    (``findings.gating``); info findings record checks that could not run.
    """
    contract = contract or default_contract(engine)
    if not getattr(engine, "batched", False):
        return {"contract": contract.to_dict(), "closures": {},
                "findings": [Finding("audit", "engine", "slot-wise engine has no step "
                                     "closures to audit", level="info")]}
    cache = T.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, engine.cache)
    gen_state = engine._gen.get_state()
    ckpt = engine._ckpt
    kernel_route = engine.fused and engine.device.type == "cuda"
    closures, out_findings = {}, []
    try:
        reg = engine.step_closures()
        # rewind takes the checkpoint of a verify pass made on this copy
        for name in sorted(reg, key=lambda n: n == "rewind"):
            entry = reg[name]
            args = engine.step_example_args(name, cache)
            stats, fs = audit_step(
                name, entry["fn"], args, contract,
                params=engine.params if entry["takes_params"] else None,
                takes_params=entry["takes_params"], cache_arg=entry["cache_arg"],
                cache_out=entry["cache_out"], kernel_route=kernel_route)
            if getattr(engine, "mesh", None) is not None:
                fs += collective_budget(name, engine.collectives[name], contract, stats)
            closures[name] = stats
            out_findings.extend(fs)
    finally:
        engine._gen.set_state(gen_state)
        engine._ckpt = ckpt
    if getattr(engine, "mesh", None) is None:
        out_findings.append(Finding("collective-budget", "engine",
                                    "no device mesh: the collective budget is not applicable",
                                    level="info"))
    return {"contract": contract.to_dict(), "closures": closures, "findings": out_findings}
