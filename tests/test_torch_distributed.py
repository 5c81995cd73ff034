"""The port's multi-device layer on the CPU: explicit SPMD over local gloo
worlds of four ranks (``launch.mesh.run_local_ranks``, one thread a rank).

One spawn of four ranks runs every multi-rank check on each mesh shape,
(2, 2) and (1, 4), of its world (``tests/_torch_mesh_ranks.py``; each
unsharded reference run once, dealt out over the ranks) and hands the
results back by shape; the tests below read them. They mirror the reference's ``tests/test_sharding.py``:

* the cascade engine (params banded by ``param_specs``, the slot grid over
  ``data``) emits exactly the unsharded port engine's tokens for the four
  families: greedy, budgeted chunked admission, speculative, sampled and
  speculative sampled (one seed);
* failover across the mesh boundary, both ways, is token-exact;
* megatron serves every stream, and its decode step counts partial-sum
  all-reduces where cascade's decode, verify, sample and spec-sample steps
  count none; the contract audit agrees;
* ``allreduce_compressed`` is bit-equal to the reference's under
  ``jax.vmap(axis_name=...)`` over the four ranks' inputs, and
  ``moe_ffn_apply_ep`` within 1e-4 of the reference's ``_local_moe``
  vmapped over the model ranks' expert slices.

World-1 checks run in this process on a gloo world of one rank; the CLIs
run as a user runs them.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_mesh_ranks as R
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.models.moe import moe_ffn_init as j_moe_ffn_init
from repro.models.moe_shardmap import _local_moe as j_local_moe
from repro.optim import grad_compression as jgc
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as meshlib
from repro_torch.models import registry
from repro_torch.optim import grad_compression as tgc

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(2, 2), (1, 4)]
FAMILIES = sorted(registry.FAMILY_SMOKE)
J_CCFG = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
GRAD_SHAPES = {"a": (8, 16), "b": (5,), "c": (3, 4, 6)}


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """The four ranks' gradients and residuals, the reference's MoE layer
    (olmoe smoke, f32) and its tokens: numpy, made from seeds."""
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal((4,) + s).astype(np.float32) for k, s in GRAD_SHAPES.items()}
    res = {k: (0.01 * rng.standard_normal((4,) + s)).astype(np.float32)
           for k, s in GRAD_SHAPES.items()}
    cfg, _ = jregistry.load("olmoe-1b-7b", smoke=True)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=50.0)
    mp = jax.tree.map(np.asarray, j_moe_ffn_init(jax.random.PRNGKey(0), cfg, J_CCFG))
    x = rng.standard_normal((2, 2, 8, cfg.d_model)).astype(np.float32)   # (data, B, S, d)
    return {"grads": grads, "residuals": res, "moe_params": mp, "moe_x": x, "moe_cfg": cfg}


@pytest.fixture(scope="module")
def worlds():
    inp = {k: v for k, v in inputs().items() if k != "moe_cfg"}
    return meshlib.run_local_ranks(4, R.mesh_checks, tuple(SHAPES), inp, timeout=600)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, worlds):
    shape = request.param
    return shape, [r[shape] for r in worlds]


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(R.MODES))
@pytest.mark.parametrize("fam", FAMILIES)
def test_mesh_cascade_engine_token_exact(world, fam, mode):
    """Every rank of the cascade mesh engine commits exactly the unsharded
    port engine's streams (the reference's test_sharding.py cases)."""
    shape, ranks = world
    ref, modes = _ran_by_one(ranks, ("serve", fam, mode), "ref", "modes")
    for r in ranks:
        res = r[("serve", fam, mode)]
        assert res["got"] == ref, (shape, fam, mode, res, ref)
        assert res["modes"][1] == modes[0]          # the unsharded engine's mode
    assert all(len(t) > 0 for t in ranks[0][("serve", fam, mode)]["got"])


def _ran_by_one(ranks, key, *fields):
    """The fields of ``key``'s result on the one rank that ran the case's
    unsharded engine (its ``fields[0]`` is set there alone)."""
    ran = [r[key] for r in ranks if r[key][fields[0]] is not None]
    assert len(ran) == 1, (key, len(ran))
    return tuple(ran[0][f] for f in fields)


@pytest.mark.parametrize("fam", FAMILIES)
def test_mesh_engine_holds_bands(world, fam):
    """The mesh engine does not degenerate to replication: model-banded
    param leaves on every rank, and on a (2, 2) mesh each data shard holds
    half the slot grid, its cache's slot axes placed over ``data`` and
    each cache leaf the band ``cache_pspecs`` gives it; ``gather_tree``
    puts the whole params back together."""
    shape, ranks = world
    for r in ranks:
        p = r[("placed", fam)]
        assert p["model_banded_leaves"] > 0, (fam, p)
        assert p["local_slots"] == p["max_batch"] // shape[0], (fam, p)
        specs = list(_spec_leaves(p["cache_specs"]))
        assert all(s.count("data") == (shape[0] > 1) for s in specs), (fam, specs)
        assert p["cache_is_its_band"] and p["gather_tree_whole"], (fam, p)
        if fam == "transformer":           # its KV heads divide the model axis: banded
            assert any("model" in s for s in specs), specs


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("dying", ["sharded", "plain"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_mesh_failover_across_the_boundary_token_exact(world, fam, dying):
    """A sharded replica dies onto an unsharded survivor (and the reverse):
    the rebuilt streams equal an undisturbed run's."""
    shape, ranks = world
    want, = _ran_by_one(ranks, ("failover", fam, dying), "want")
    for r in ranks:
        res = r[("failover", fam, dying)]
        assert res["started"]
        assert res["got"] == want, (shape, fam, dying, res, want)


# ---------------------------------------------------------------------------
# collective counts and the contract
# ---------------------------------------------------------------------------

def test_mesh_megatron_serves_with_partial_sums(world):
    shape, ranks = world
    for r in ranks:
        assert all(len(t) == 6 for t in r["megatron_streams"])
        dec = r["megatron_decode"]
        assert dec["all_reduce_sum"]["calls"] > 0, dec
        # one all-reduce a row module (wo, w_down) a layer, and the embedding
        assert dec["all_reduce_sum"]["calls"] == 2 * 2 + 1, dec


def test_mesh_megatron_tied_head_serves_the_whole_vocabulary(world):
    """Megatron bands a tied table on the vocabulary: the head's logits are
    all-gathered, so every rank commits the same global token ids."""
    shape, ranks = world
    first = ranks[0]["megatron_tied"]
    assert first["tied"] and first["table_band"] == (-2 if shape[1] > 1 else None)
    for r in ranks:
        got = r["megatron_tied"]
        assert got["streams"] == first["streams"], (shape, got["streams"], first["streams"])
        assert all(len(t) == 6 for t in got["streams"])
        # out_proj a layer and the embedding all-reduce; the head gathers
        assert got["decode"]["all_reduce_sum"]["calls"] == 2 + 1, got["decode"]
        assert got["decode"]["all_gather"]["calls"] > 0, got["decode"]


@pytest.mark.parametrize("closure", ["decode", "verify", "sample", "spec_sample"])
def test_mesh_cascade_closures_count_no_partial_sum(world, closure):
    shape, ranks = world
    for r in ranks:
        aud = r["audit_cascade"] if closure in r["audit_cascade"]["psum"] else \
            r["audit_cascade_greedy"]
        assert aud["psum"][closure] == 0, (closure, aud)
        assert aud["gathers"][closure] > 0, (closure, aud)


def test_mesh_audit_cascade_clean_megatron_strict_trips(world):
    shape, ranks = world
    for r in ranks:
        assert r["audit_cascade"]["gating"] == [] and r["audit_cascade_greedy"]["gating"] == []
        strict = r["audit_megatron_strict"]
        assert strict["decode_psum"] > 0
        assert any(f["check"] == "collective-budget" and f["where"] == "decode"
                   for f in strict["gating"]), strict
        assert r["audit_megatron_default"] == []


# ---------------------------------------------------------------------------
# compressed all-reduce and expert parallelism against the reference
# ---------------------------------------------------------------------------

def _reference_compressed(inp):
    """The reference's allreduce_compressed, and its psum of the codes,
    vmapped over the four ranks' inputs."""
    def codes_sum(g, r):
        gf = g.astype(jnp.float32) + r
        scale = jax.lax.pmax(jnp.max(jnp.abs(gf)) / 127.0 + 1e-12, "data")
        q = jnp.clip(jnp.round(gf / scale), -127, 127)
        return jax.lax.psum(q.astype(jnp.int32), "data")
    g = {k: jnp.asarray(v) for k, v in inp["grads"].items()}
    r = {k: jnp.asarray(v) for k, v in inp["residuals"].items()}
    mean, new_r = jax.vmap(lambda a, b: jgc.allreduce_compressed(a, b, "data"),
                           axis_name="data")(g, r)
    sums = {k: jax.vmap(codes_sum, axis_name="data")(g[k], r[k]) for k in g}
    return ({k: np.asarray(v) for k, v in sums.items()},
            {k: np.asarray(v) for k, v in mean.items()},
            {k: np.asarray(v) for k, v in new_r.items()})


def test_allreduce_compressed_world4_bit_equal(world):
    shape, ranks = world
    sums, mean, new_r = _reference_compressed(inputs())
    for rank, r in enumerate(ranks):
        c = r["compression"]
        for k in GRAD_SHAPES:
            np.testing.assert_array_equal(c["sums"][k], sums[k][rank])
            np.testing.assert_array_equal(c["mean"][k], mean[k][rank])
            np.testing.assert_array_equal(c["residuals"][k], new_r[k][rank])


def test_moe_ffn_apply_ep_world4(world):
    """Each model rank's expert band through the EP dispatch: within 1e-4 of
    the reference's _local_moe vmapped over the model ranks' expert slices,
    and of the port's drop-free moe_ffn_apply on the whole layer."""
    shape, ranks = world
    inp = inputs()
    cfg, mp = inp["moe_cfg"], inp["moe_params"]
    m = shape[1]
    for r in ranks:
        d = r["coords"]["data"]
        xd = inp["moe_x"][d]
        b, s, dm = xd.shape
        cap = max(8, -(-int(np.ceil(cfg.moe_capacity_factor * b * s * cfg.moe_top_k
                                     / cfg.n_experts)) // 8) * 8)
        split = lambda w: jnp.asarray(w).reshape((m, w.shape[0] // m) + w.shape[1:])
        fn = functools.partial(j_local_moe, cfg=cfg, ccfg=J_CCFG, model_axis="model",
                               cap=cap, fp4=False)
        y = jax.vmap(fn, in_axes=(None, None, 0, 0, 0), axis_name="model")(
            jnp.asarray(xd.reshape(b * s, dm)), jnp.asarray(mp["router"]),
            split(mp["wg"]["w"]), split(mp["wu"]["w"]), split(mp["wd"]["w"]))
        want = np.asarray(y[r["coords"]["model"]]).reshape(b, s, dm)
        assert r["moe_ep"]["e_local"] == cfg.n_experts // m
        assert r["moe_ep"]["model_dispatch_equal"]        # MoELM._moe_ffn under moe_ep
        np.testing.assert_allclose(r["moe_ep"]["y_ep"], want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["moe_ep"]["y_ep"], r["moe_ep"]["y_full"],
                                   atol=1e-4, rtol=1e-4)


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, torn down after the test."""
    import torch.distributed as dist
    meshlib.init_world(0, 1, meshlib.free_port())
    yield meshlib.make_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def test_allreduce_compressed_world1_bit_equal(world_of_one):
    import torch.distributed as dist
    inp = inputs()
    g = {k: v[0] for k, v in inp["grads"].items()}
    r = {k: v[0] for k, v in inp["residuals"].items()}
    jm, jr = jgc.allreduce_compressed({k: jnp.asarray(v) for k, v in g.items()},
                                      {k: jnp.asarray(v) for k, v in r.items()}, ())
    tm, tr = tgc.allreduce_compressed({k: torch.from_numpy(v) for k, v in g.items()},
                                      {k: torch.from_numpy(v) for k, v in r.items()},
                                      dist.group.WORLD)
    for k in g:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))


def test_moe_ffn_apply_ep_1x1_matches_reference(world_of_one):
    """On a (1, 1) mesh the EP dispatch equals the reference's
    ``moe_ffn_apply_ep`` (test_substrates.py's case) within 1e-4."""
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.models.moe_shardmap import moe_ffn_apply_ep as j_ep
    from repro_torch.models.moe_shardmap import moe_ffn_apply_ep
    inp = inputs()
    cfg, mp = inp["moe_cfg"], inp["moe_params"]
    x = inp["moe_x"][0]
    want = j_ep(jax.tree.map(jnp.asarray, mp), jnp.asarray(x), cfg, J_CCFG,
                j_make_mesh((1, 1), ("data", "model")))
    got = moe_ffn_apply_ep(params_from_numpy(mp, device="cpu"), torch.from_numpy(x), cfg,
                           R.CCFG, world_of_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

SERVE = ["--smoke", "--device", "cpu", "--requests", "3", "--max-new", "5"]


def _streams(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.strip().startswith("req ")]


def test_serve_cli_on_a_mesh_gives_the_meshless_tokens(capsys):
    from repro_torch.launch import serve as scli
    assert scli.main(SERVE) == 0
    plain = _streams(capsys.readouterr().out)
    assert scli.main(SERVE + ["--host-devices", "4", "--mesh", "2x2"]) == 0
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'model': 2} tp_policy=cascade" in out
    assert len(plain) == 3 and _streams(out) == plain


@pytest.mark.parametrize("policy,rc", [("cascade", 0), ("megatron", 1)])
def test_serve_cli_verify_collectives(capsys, policy, rc):
    from repro_torch.launch import serve as scli
    assert scli.main(SERVE + ["--host-devices", "4", "--mesh", "1x4", "--tp-policy", policy,
                              "--verify-collectives"]) == rc
    out = capsys.readouterr().out
    assert "collectives decode: all_gather" in out
    assert ("FAIL" in out) == (rc == 1)


def test_serve_cli_mesh_needs_its_ranks(capsys):
    """A 2x2 mesh in a world of one rank raises, naming the ranks it needs."""
    from repro_torch.launch import serve as scli
    with pytest.raises(ValueError, match="needs 4 ranks"):
        scli.main(SERVE + ["--mesh", "2x2"])


def test_train_cli_host_mesh_megatron_losses_bit_equal():
    """The step runs unsharded on the host mesh, as the reference's: the
    losses with --mesh host --tp-policy megatron are the run's without."""
    from repro_torch.launch import train as tcli
    args = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--qat"]
    plain, meg = [], []
    assert tcli.main(args, losses=plain) == 0
    assert tcli.main(args + ["--mesh", "host", "--tp-policy", "megatron"], losses=meg) == 0
    assert len(plain) == 3 and plain == meg


def test_planned_rows_scope_names_the_whole_grid_for_the_shards_rows_only():
    """``ops.planned_rows`` (a data shard's attention plans as the whole
    grid's) applies to a launch over the shard's rows alone, inside its
    scope (the launches themselves are held on the card:
    test_torch_gpu.py)."""
    from repro_torch.kernels import ops
    assert ops._plan_kw(4) == {}
    with ops.planned_rows(4, 8):
        assert ops._plan_kw(4) == {"plan_rows": 8} and ops._plan_kw(1) == {}
        with ops.planned_rows(2, 8):
            assert ops._plan_kw(2) == {"plan_rows": 8} and ops._plan_kw(4) == {}
        assert ops._plan_kw(4) == {"plan_rows": 8}
    assert ops._plan_kw(4) == {}
