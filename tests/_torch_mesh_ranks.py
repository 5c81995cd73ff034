"""The per-rank half of ``tests/test_torch_distributed.py``: the checks one
rank of a local gloo world runs, imported by the spawned ranks (this module
imports torch and the port only, so a rank starts without JAX).

``mesh_checks(rank, shapes, inputs)`` runs every multi-rank check on each
(data, model) mesh of ``shapes`` over one world of four ranks and returns,
by shape, plain Python and numpy results for the test process to hold
against the unsharded port engine and the reference.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.core.cascade import CascadeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import collectives, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

CCFG = CascadeConfig(mode="train", compute_dtype=torch.float32)
LENS = [8, 5, 12, 3, 20, 9]

#: name -> (prompt lengths, ServeConfig overrides): the reference's
#: test_sharding.py cases
MODES = {
    "greedy": (LENS, {}),
    "budgeted": ([17, 8, 29, 4], {"max_batch": 2, "token_budget": 8}),
    "spec": (LENS, {"draft_len": 4}),
    "sampled": (LENS, {"temperature": 1.0, "top_k": 5, "sample_seed": 7}),
    "spec_sampled": (LENS, {"draft_len": 3, "temperature": 0.9, "top_k": 6,
                            "sample_seed": 13}),
}


def requests(cfg, lens, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]


def scfg(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 8)
    return ServeConfig(**kw)


def run(model, params, cfg, lens, sc, mesh=None, max_new=6):
    eng = ServeEngine(model, params, CCFG, sc, mesh=mesh, device="cpu")
    reqs = requests(cfg, lens, max_new=max_new)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(400)
    return [r.tokens_out for r in reqs], eng


def failover(model, params, cfg, mesh, dying: str):
    """A sharded replica dies onto an unsharded survivor (or the reverse):
    the streams, the clones' where a stream was rebuilt."""
    from repro_torch.serve.elastic import ReplicaSet
    e0 = ServeEngine(model, params, CCFG, scfg(max_batch=2),
                     mesh=mesh if dying == "sharded" else None, device="cpu")
    e1 = ServeEngine(model, params, CCFG, scfg(max_batch=2),
                     mesh=None if dying == "sharded" else mesh, device="cpu")
    rs = ReplicaSet([e0, e1])
    victims = requests(cfg, [8, 12], max_new=10)
    for v in victims:
        rs.engines[0].submit(v)
    for _ in range(3):
        rs.step()
    started = any(len(v.tokens_out) > 0 for v in victims)
    rs.kill_replica(0)
    rs.drain(400)
    clones = {c.uid: c.tokens_out for c in rs.requeued}
    return started, [clones.get(v.uid, v.tokens_out) for v in victims]


def placed(eng, params) -> dict:
    """Whether the mesh engine really holds bands: model-banded param
    leaves; this rank's slot rows of the grid, its cache leaves the bands
    ``cache_pspecs`` gives the whole grid's; and ``gather_tree`` of the
    rank's params gives the whole params back."""
    from repro_torch import tree as T
    whole = eng.model.init_cache(eng.scfg.max_batch, eng._cache_len, device="meta")
    want = T.tree_map(lambda t, s: tuple(sharding.local_band(t, s, eng.mesh).shape),
                      whole, eng.cache_specs)
    got = T.tree_map(lambda t: tuple(t.shape), eng.cache)
    back = sharding.gather_tree(eng.params, eng.param_specs, eng.mesh)
    return {"model_banded_leaves": len(eng._policy._bands),
            "local_slots": eng._b1 - eng._b0, "max_batch": eng.scfg.max_batch,
            "cache_specs": eng.cache_specs, "cache_is_its_band": got == want,
            "gather_tree_whole": all(torch.equal(a, b) for a, b in
                                     zip(T.leaves(back), T.leaves(params)))}


def serve_checks(meshes: dict) -> dict:
    """Each mesh run of every family and mode on each of ``meshes`` (shape
    -> mesh), on every rank; the unsharded engine's run of the same case
    (``ref``, its mode, and the undisturbed run a failover is held to) once,
    on one rank only, the cases dealt out in turn over the ranks (the test
    reads each from the rank that ran it). Returns the results by shape."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {shape: {} for shape in meshes}
    case = 0
    for fam, arch in sorted(registry.FAMILY_SMOKE.items()):
        cfg, model = registry.load(arch, smoke=True)
        params = model.init_params(0, CCFG, device="cpu")
        for mode, (lens, kw) in MODES.items():
            ref, mode0 = None, None
            if case % world == rank:
                ref, e0 = run(model, params, cfg, lens, scfg(**kw))
                mode0 = e0.effective_mode
            case += 1
            for shape, mesh in meshes.items():
                got, eng = run(model, params, cfg, lens, scfg(**kw), mesh=mesh)
                out[shape][("serve", fam, mode)] = {"ref": ref, "got": got,
                                                    "modes": (mode0, eng.effective_mode)}
                if mode == "greedy":
                    out[shape][("placed", fam)] = placed(eng, params)
        want = None
        if case % world == rank:
            want, _ = run(model, params, cfg, [8, 12], scfg(max_batch=2), max_new=10)
        case += 1
        for shape, mesh in meshes.items():
            for dying in ("sharded", "plain"):
                started, got = failover(model, params, cfg, mesh, dying)
                out[shape][("failover", fam, dying)] = {"want": want, "got": got,
                                                        "started": started}
    return out


def contract_checks(mesh) -> dict:
    """Megatron serves; the collective counts of each closure; the audit
    of a cascade mesh engine, and of megatron held to zero partial sums."""
    from repro_torch.analysis import contract
    from repro_torch.analysis.findings import gating
    cfg, model = registry.load(registry.FAMILY_SMOKE["transformer"], smoke=True)
    params = model.init_params(0, CCFG, device="cpu")
    out = {}
    got, eng = run(model, params, cfg, [8, 5], scfg(tp_policy="megatron"), mesh=mesh)
    out["megatron_streams"] = got
    out["megatron_decode"] = eng.step_closures()["decode"]["collectives"]
    # the SSM family's smoke config ties its head to the embedding, which
    # megatron bands on the vocabulary
    tcfg, tmodel = registry.load(registry.FAMILY_SMOKE["ssm"], smoke=True)
    tparams = tmodel.init_params(0, CCFG, device="cpu")
    got, eng = run(tmodel, tparams, tcfg, [8, 5, 12], scfg(tp_policy="megatron"), mesh=mesh)
    out["megatron_tied"] = {"streams": got, "tied": bool(tcfg.tie_embeddings),
                            "table_band": eng._policy.band(eng.params["embed"]["table"]),
                            "decode": eng.step_closures()["decode"]["collectives"]}
    for name, kw in (("cascade", dict(draft_len=2, temperature=0.7)),
                     ("cascade_greedy", dict(draft_len=2))):
        eng = ServeEngine(model, params, CCFG, scfg(**kw), mesh=mesh, device="cpu")
        res = contract.audit_engine(eng)
        out[f"audit_{name}"] = {
            "gating": [f.to_dict() for f in gating(res["findings"])],
            "psum": {n: c["partial_sum_allreduces"] for n, c in res["closures"].items()},
            "gathers": {n: c["collectives"]["all_gather"]["calls"]
                        for n, c in res["closures"].items()}}
    eng = ServeEngine(model, params, CCFG, scfg(tp_policy="megatron"), mesh=mesh, device="cpu")
    strict = contract.audit_engine(eng, contract.ServingContract(max_partial_sum_allreduces=0))
    out["audit_megatron_strict"] = {
        "gating": [f.to_dict() for f in gating(strict["findings"])],
        "decode_psum": strict["closures"]["decode"]["partial_sum_allreduces"]}
    out["audit_megatron_default"] = [f.to_dict() for f in
                                     gating(contract.audit_engine(eng)["findings"])]
    return out


def compression_checks(inputs: dict) -> dict:
    """``allreduce_compressed`` over the whole world on this rank's grads."""
    import torch.distributed as dist
    from repro_torch.optim import grad_compression as gc
    rank = dist.get_rank()
    grads = {k: torch.from_numpy(v[rank]) for k, v in inputs["grads"].items()}
    res = {k: torch.from_numpy(v[rank]) for k, v in inputs["residuals"].items()}
    sums = {k: gc.compressed_sum(grads[k], res[k], dist.group.WORLD)[0].numpy()
            for k in grads}
    mean, new_r = gc.allreduce_compressed(grads, res, dist.group.WORLD)
    return {"sums": sums, "mean": {k: v.numpy() for k, v in mean.items()},
            "residuals": {k: v.numpy() for k, v in new_r.items()}}


def moe_ep_checks(mesh, inputs: dict) -> dict:
    """``moe_ffn_apply_ep`` on this rank's band of the reference's experts
    (placed by megatron's spec, E over ``model``) and this data shard's
    tokens; and the drop-free ``moe_ffn_apply`` on the whole layer."""
    from repro_torch.models.moe import moe_ffn_apply
    from repro_torch.models.moe_shardmap import moe_ffn_apply_ep
    cfg = registry.get_config("olmoe-1b-7b", smoke=True)
    import dataclasses
    cfg = dataclasses.replace(cfg, moe_capacity_factor=50.0)
    params = params_from_numpy(inputs["moe_params"], device="cpu")
    specs = sharding.filter_divisible(sharding.param_specs(params, "megatron"), params, mesh)
    local = sharding.shard_tree(params, specs, mesh)
    x = torch.from_numpy(inputs["moe_x"])                          # (D, B, S, d)
    xd = x[mesh.coord("data")]
    y_ep = moe_ffn_apply_ep(local, xd, cfg, CCFG, mesh)
    y_full = moe_ffn_apply(params, xd, cfg, CCFG)
    # the model's dispatch under a policy installed with moe_ep
    model = registry.build_model(cfg)
    pol = sharding.ActivationPolicy(mesh, "megatron", local, specs, moe_ep=True)
    with sharding.activation_policy(pol):
        y_model = model._moe_ffn(local, xd, CCFG)
    return {"y_ep": y_ep.numpy(), "y_full": y_full.numpy(),
            "model_dispatch_equal": bool(torch.equal(y_model, y_ep)),
            "e_local": int(local["wg"]["w"].shape[0])}


def mesh_checks(rank: int, shapes: tuple, inputs: dict) -> dict:
    meshes = {shape: make_mesh(shape, ("data", "model")) for shape in shapes}
    collectives.reset_counts()
    out = serve_checks(meshes)
    compression = compression_checks(inputs)          # over the whole world
    for shape, mesh in meshes.items():
        out[shape].update(contract_checks(mesh))
        out[shape].update(coords=dict(mesh.coords), compression=compression,
                          moe_ep=moe_ep_checks(mesh, inputs))
    return out


# ---------------------------------------------------------------------------
# the cache's model bands (the dry run's cache_specs placement)
# ---------------------------------------------------------------------------

def _band_batch(inp: dict, lo: int, hi: int) -> dict:
    """The batch of positions [lo, hi) of a family's numpy inputs."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if "embeds" in inp:
        out = {"inputs_embeds": t(inp["embeds"][:, lo:hi])}
        if "positions" in inp:
            out["positions"] = t(inp["positions"][:, :, lo:hi])
        return out
    return {"tokens": t(inp["tokens"][:, lo:hi])}


def decode_with_bands(model, params, mesh, inp: dict, ccfg=CCFG, tp_policy="cascade"):
    """A prefill of ``inp["prompt_len"]`` positions, then a decode step for
    each of ``inp["steps"]`` more: once unsharded, once on ``mesh`` with the
    params on their bands and the prefill's cache cut by the whole of
    ``cache_specs``. Returns both runs' logits and caches (the sharded cache
    gathered whole), and the bytes of each banded leaf on this rank and
    whole."""
    from repro_torch import tree as T
    s, n = inp["prompt_len"], inp["steps"]

    def run(p, policy, place):
        with sharding.activation_policy(policy):
            logits, cache = model.prefill(p, _band_batch(inp, 0, s), ccfg, max_len=inp["max_len"])
            cache, out = place(cache), [logits]
            for j in range(n):
                logits, cache = model.decode_step(p, _band_batch(inp, s + j, s + j + 1), cache,
                                                  ccfg)
                out.append(logits)
        return [o.float().numpy() for o in out], cache

    want_logits, want_cache = run(params, None, lambda c: c)
    tied = bool(getattr(model.cfg, "tie_embeddings", False))
    pspecs = sharding.placed_param_specs(params, mesh, tp_policy, tied)
    local = sharding.shard_tree(params, pspecs, mesh)
    cspecs = sharding.cache_specs(want_cache, mesh)
    pol = sharding.ActivationPolicy(mesh, tp_policy, local, pspecs, cache_bands=cspecs)
    got_logits, band_cache = run(local, pol, lambda c: sharding.shard_tree(c, cspecs, mesh))
    banded = {"/".join(p): (t.numel() * t.element_size(),
                            sharding._spec_at(cspecs, p))
              for p, t in T.leaves_with_paths(band_cache)}
    whole = {"/".join(p): t.numel() * t.element_size()
             for p, t in T.leaves_with_paths(want_cache)}
    back = sharding.gather_tree(band_cache, cspecs, mesh)
    as_np = lambda c: {"/".join(p): (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                       for p, t in T.leaves_with_paths(c)}
    return {"want": want_logits, "got": got_logits, "cache_want": as_np(want_cache),
            "cache_got": as_np(back), "bytes": {k: (banded[k][0], whole[k], banded[k][1])
                                                for k in whole},
            "model_bands": dict(pol._cache_bands)}


def train_grads_on_mesh(mesh, tp_policy: str, tokens: np.ndarray, full_dp: bool = False) -> dict:
    """The loss and its gradients of the dense smoke model on ``mesh`` (the
    params on their ``tp_policy`` bands, the gradients gathered whole)
    beside the unsharded ones: the differentiable collectives' check. With
    ``full_dp`` each model rank takes its own rows of the batch (the dry
    run's full data parallelism: the banded params gathered whole,
    ``dryrun.WholeParams``), and the gradients are averaged over the model
    ranks as the dry run's train cell averages them."""
    from repro_torch import tree as T
    from repro_torch.launch.dryrun import WholeParams
    from repro_torch.train.loop import cross_entropy
    cfg, model = registry.load(registry.FAMILY_SMOKE["transformer"], smoke=True)
    params = model.init_params(0, CCFG, device="cpu")
    whole = {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    m, r = mesh.size("model"), mesh.coord("model")
    rows = tokens.shape[0] // m
    mine = {k: v[r * rows:(r + 1) * rows] for k, v in whole.items()} if full_dp else whole

    def grads(p, specs, batch):
        p = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        policy, run = None, model
        if specs is not None and full_dp:
            run = WholeParams(model, specs, mesh)
        elif specs is not None:
            policy = sharding.ActivationPolicy(mesh, tp_policy, p, specs)
        with sharding.activation_policy(policy):
            loss = cross_entropy(run.forward(p, batch, CCFG), batch["labels"])
            g = torch.autograd.grad(loss, T.leaves(p))
        return loss.item(), T.unflatten_like(p, list(g))

    want_loss, want = grads(params, None, whole)
    pspecs = sharding.placed_param_specs(params, mesh, tp_policy)
    got_loss, got = grads(sharding.shard_tree(params, pspecs, mesh), pspecs, mine)
    if full_dp:
        group = mesh.group("model")
        got_loss = collectives.all_reduce(torch.tensor(got_loss), group).item() / m
        got = sharding._map2(lambda g, s: (g if "model" in s else
                                           collectives.all_reduce(g, group)) / m, got, pspecs)
    got = sharding.gather_tree(got, pspecs, mesh)
    return {"loss": (want_loss, got_loss),
            "grads": [(a.numpy(), b.numpy()) for a, b in zip(T.leaves(want), T.leaves(got))]}


def train_step_on_mesh(mesh, tp_policy: str, tokens: np.ndarray, full_dp: bool = False) -> dict:
    """One step of the dry run's train cell (``dryrun.build_cell``: remat,
    AdamW, the gradient mean and the clip's norm over the bands) on this
    rank's bands of the dense smoke model's params, with real tensors,
    beside ``make_train_step`` on the whole params: the gradient norm, and
    the updated params and moments gathered whole, of each."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import loop
    arch = registry.FAMILY_SMOKE["transformer"]
    cfg, model = registry.load(arch, smoke=True)
    params = model.init_params(0, CCFG, device="cpu")
    whole = {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    shape = ShapeConfig("smoke_train", tokens.shape[1] - 1, tokens.shape[0], "train")
    cell = dryrun.build_cell(arch, shape, mesh, CCFG, tp_policy, full_dp=full_dp, cfg=cfg)
    pspecs = cell.trees["params"][1]
    b0, nb = dryrun._data_rows(mesh, cell.batch_axes, tokens.shape[0])
    local = sharding.shard_tree(params, pspecs, mesh)
    args = {"params": T.tree_map(lambda t: t.detach().clone().requires_grad_(True), local),
            "batch": {k: v[b0:b0 + nb] for k, v in whole.items()},
            "step": torch.zeros((), dtype=torch.int32)}
    args["opt"] = AdamW().init(args["params"])
    with sharding.activation_policy(cell.policy(args)):
        got = cell.step(args)
    ref = loop.TrainState(params=T.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                            params),
                          opt=AdamW().init(params), step=torch.zeros((), dtype=torch.int32))
    ref, want = loop.make_train_step(model, CCFG, AdamW(), remat=True)(ref, whole)
    as_np = lambda tree: [t.detach().numpy() for t in T.leaves(tree)]
    gather = lambda tree: sharding.gather_tree(T.tree_map(lambda t: t.detach(), tree), pspecs,
                                               mesh)
    return {"gnorm": (float(want["gnorm"]), float(got["gnorm"])),
            "params": list(zip(as_np(ref.params), as_np(gather(args["params"])))),
            "mu": list(zip(as_np(ref.opt.mu), as_np(gather(args["opt"].mu)))),
            "nu": list(zip(as_np(ref.opt.nu), as_np(gather(args["opt"].nu))))}


def band_checks(rank: int, shape: tuple, inputs: dict) -> dict:
    """Every family of ``inputs["bands"]`` decoding with all of
    ``cache_specs`` placed on ``shape`` (at the depths it gives), the dry run's
    smoke cell on this world with real tensors (its counted collectives,
    for the fake world's to equal) and a training step's gradients on the
    mesh under both policies."""
    from repro_torch.launch import dryrun
    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for key, inp in inputs["bands"].items():
        cfg = dataclasses.replace(registry.get_config(inp["arch"], smoke=True),
                                  n_layers=inp["n_layers"],
                                  first_dense_layers=inp["first_dense_layers"])
        model = registry.build_model(cfg)
        params = params_from_numpy(inp["params"], device="cpu")
        out[key] = decode_with_bands(model, params, mesh, inp)
    for policy in ("cascade", "megatron"):
        for full_dp in (False, True):
            out[("train", policy, full_dp)] = train_grads_on_mesh(
                mesh, policy, inputs["train_tokens"], full_dp)
            out[("step", policy, full_dp)] = train_step_on_mesh(
                mesh, policy, inputs["train_tokens"], full_dp)
    cfg = registry.get_config(inputs["cell"]["arch"], smoke=True)
    cell = dryrun.build_cell(inputs["cell"]["arch"], inputs["cell"]["shape"], mesh,
                             tp_policy=inputs["cell"]["tp_policy"], cfg=cfg)
    args = cell.local_args(lambda s, dt: torch.zeros(s, dtype=dt))
    before = collectives.snapshot()
    with sharding.activation_policy(cell.policy(args)):
        cell.step(args)
    out["cell_collectives"] = collectives.since(before)
    return out


def fail_on_rank_one(eng) -> list:
    """A serve CLI check (``launch.serve.main(checks=...)``) that fails on
    rank 1 of a mesh engine alone."""
    return ["FAIL: planted check on rank 1"] if eng.mesh.rank == 1 else []
