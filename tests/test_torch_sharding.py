"""The port's placement specs against the reference's, leaf for leaf.

``repro_torch.distributed.sharding`` returns each leaf's spec as a plain
tuple of per-dim axis names; the reference returns ``PartitionSpec``s. Both
are held to each other on every registry arch's smoke params and caches,
and at full width on meta tensors shaped by the reference's
``jax.eval_shape`` for llama3.1-405b, deepseek-v2-236b and qwen2.5-32b:
``param_specs`` (cascade and megatron, tied and untied), ``filter_divisible``
and ``add_data_dim`` on a stub mesh of data 4 x model 2, ``batch_specs``,
``cache_specs``, the models' ``cache_pspecs`` (``data`` exactly on the
probed slot axis) and ``parse_mesh_shape``.

Where the port's trees differ from the reference's (Griffin's params are
one ``layers`` list, the reference's stacked ``groups``; the MoE and Griffin
caches are stacked otherwise), the reference's specs are carried across as
``convert.params_from_numpy`` carries the leaves.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.core import cascade as jcascade
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

ARCHS = sorted(set(registry.ALIASES.values()) | {"llama31_405b"})
FULL = ["llama31_405b", "deepseek-v2-236b", "qwen2.5-32b"]
POLICIES = [("cascade", False), ("megatron", False), ("cascade", True), ("megatron", True)]


class StubMesh:
    shape = {"data": 4, "model": 2}


def _tuple(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _flat(tree, path=()):
    """(path, leaf) pairs; a spec tuple, PartitionSpec or array is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _ref_flat(specs, shapes):
    """{path: spec tuple} of a reference spec tree over its shape tree."""
    sh = dict(_flat(jax.tree.map(lambda a: a, shapes)))
    return {p: _tuple(s, sh[p].ndim) for p, s in _flat(jax.tree.map(
        lambda s: s, specs, is_leaf=lambda x: isinstance(x, P)))}


def _bridge(ref: dict, shapes) -> dict:
    """Reference {path: spec} over Griffin's groups/tail -> the port's one
    ``layers`` list (a group's leaves lose their leading group axis)."""
    if not any(p[0] == "groups" for p in ref):
        return ref
    blocks = sorted({p[1] for p in ref if p[0] == "groups"}, key=lambda n: int(n[1:]))
    n_groups = next(v.shape[0] for p, v in _flat(shapes) if p[0] == "groups")
    out = {p: s for p, s in ref.items() if p[0] not in ("groups", "tail")}
    for p, s in ref.items():
        if p[0] == "groups":
            i = blocks.index(p[1])
            for g in range(n_groups):
                out[("layers", str(g * len(blocks) + i)) + p[2:]] = s[1:]
        elif p[0] == "tail":
            out[("layers", str(n_groups * len(blocks) + int(p[1]))) + p[2:]] = s
    return out


def _ref_tree(arch, full=False):
    """The reference's FP4 param tree as ``jax.eval_shape`` gives it (the
    specs read shapes only), its config and model."""
    cfg, jm = jregistry.load(arch, smoke=not full)
    dt = jnp.bfloat16 if full else jnp.float32
    train = jcascade.CascadeConfig(mode="train", compute_dtype=dt)
    fp4 = jcascade.CascadeConfig(mode="serve_fp4", compute_dtype=dt)
    return cfg, jm, jax.eval_shape(
        lambda: jcascade.tree_to_serve_fp4(jm.init_params(jax.random.PRNGKey(0), train), fp4))


def _meta(tree):
    """Meta tensors of a shape-struct tree's shapes (no storage)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


def _port_tree(ref, full):
    """The port's tree of the reference's shapes: meta tensors at full
    width; at smoke size zeros carried across by ``params_from_numpy``
    (which also unstacks Griffin's groups)."""
    if full:
        return _meta(ref)
    return params_from_numpy(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), ref),
                             device="cpu")


CASES = [(a, False) for a in ARCHS] + [(a, True) for a in FULL]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0] + ("-full" if c[1] else ""))
def trees(request):
    arch, full = request.param
    cfg, jm, ref = _ref_tree(arch, full)
    return arch, full, cfg, jm, ref, _port_tree(ref, full)


@pytest.mark.parametrize("policy,tied", POLICIES, ids=[f"{p}{'-tied' if t else ''}"
                                                       for p, t in POLICIES])
def test_param_specs_filter_and_data_dim_equal_the_reference(trees, policy, tied):
    arch, full, cfg, jm, ref, port = trees
    mesh = StubMesh()
    jspec = jshd.param_specs(ref, policy, tied_embed=tied)
    tspec = tshd.param_specs(port, policy, tied_embed=tied)
    jf = jshd.filter_divisible(jspec, ref, mesh)
    tf = tshd.filter_divisible(tspec, port, mesh)
    jd = jshd.add_data_dim(jf, ref, mesh)
    td = tshd.add_data_dim(tf, port, mesh)
    for name, j, t in (("param_specs", jspec, tspec), ("filter_divisible", jf, tf),
                       ("add_data_dim", jd, td)):
        want = _bridge(_ref_flat(j, ref), ref)
        got = dict(_flat(t))
        assert got == want, (arch, name, {p: (got.get(p), want.get(p))
                                          for p in set(got) | set(want)
                                          if got.get(p) != want.get(p)})


def _cache_pair(arch, jm, full):
    cfg, tm = registry.load(arch, smoke=not full)
    t = 256 if full else 32
    jc = jax.eval_shape(lambda: jm.init_cache(4, t, dtype=jnp.float32))
    tc = tm.init_cache(4, t, dtype=torch.float32, device="meta")
    return tm, jc, tc


def _by_leaf_name(ref_flat: dict) -> dict:
    """(name, rank) -> the set of specs of the reference's cache leaves of
    that name and rank (its stacking differs from the port's for MLA and
    Griffin: the port stacks every layer's cache), a per-slot leaf beside
    the stacks by its path."""
    out = {}
    for p, s in ref_flat.items():
        key = (p[-1] if len(p) > 1 else p, len(s))
        out.setdefault(key, set()).add(s)
    return out


def test_cache_specs_and_batch_specs_equal_the_reference(trees):
    arch, full, cfg, jm, ref, port = trees
    mesh = StubMesh()
    tm, jc, tc = _cache_pair(arch, jm, full)
    ref_flat = _ref_flat(jshd.cache_specs(jc, mesh), jc)
    want = _by_leaf_name(ref_flat)
    for p, s in _flat(tshd.cache_specs(tc, mesh)):
        key = (p[-1] if len(p) > 1 else p, len(s))
        assert want.get(key) == {s}, (arch, p, s, want.get(key))
    for b in (4, 3):
        batch = {"tokens": np.zeros((b, 8), np.int32), "positions": np.zeros((3, b, 8), np.int32)}
        j = _ref_flat(jshd.batch_specs(batch, mesh=mesh), batch)
        t = dict(_flat(tshd.batch_specs(batch, mesh=mesh)))
        assert t == j, (arch, b, t, j)


def test_cache_pspecs_put_data_on_the_probed_slot_axis(trees):
    """The port's probe finds each leaf's slot axis, and ``cache_pspecs``
    puts ``data`` there and nowhere else (test_sharding.py's check); where
    the caches' trees agree, its specs are the reference's."""
    arch, full, cfg, jm, ref, port = trees
    mesh = StubMesh()
    tm, jc, tc = _cache_pair(arch, jm, full)
    from repro_torch.models import cache_utils
    axes = dict(_flat(cache_utils.probe_slot_axes(
        lambda b, t: tm.init_cache(b, t, device="meta"))))
    specs = dict(_flat(tm.cache_pspecs(tc, mesh)))
    assert set(axes) == set(specs)
    for p, spec in specs.items():
        ax, leaf = axes[p], dict(_flat(tc))[p]
        for i, name in enumerate(spec):
            assert name == ("data" if i == ax and leaf.shape[ax] % 4 == 0 else None), (p, spec)
    jspecs = _ref_flat(jm.cache_pspecs(jc, mesh), jc)
    if set(jspecs) == set(specs):
        assert jspecs == specs


@pytest.mark.parametrize("n", [1, 4, 8, 16])
def test_parse_mesh_shape_equals_the_reference(monkeypatch, n):
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * n)
    for spec in ("4x2", "2x2", "auto"):
        assert tmesh.parse_mesh_shape(spec, n) == jmesh.parse_mesh_shape(spec), (spec, n)


def test_mesh_needs_its_ranks():
    """A mesh larger than the world (or with no world) raises, naming the
    ranks it needs; the production meshes need 256 and 512."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)


class StubRank:
    """One rank of a (data 2, model 2) mesh, as ``shard_tree`` reads it (a
    param spec names no data axis, so the model coordinate picks the band)."""
    shape = {"data": 2, "model": 2}

    def __init__(self, model: int):
        self.coords = {"data": 1, "model": model}

    def size(self, axis):
        return self.shape.get(axis, 1)

    def coord(self, axis):
        return self.coords.get(axis, 0)


PLACED_ARCHS = sorted(set(registry.FAMILY_SMOKE.values()) | {"phi4-mini-3.8b",
                                                             "deepseek-v2-236b"})


@pytest.mark.parametrize("policy", ["cascade", "megatron"])
@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_param_placer_draws_each_rank_its_bands(arch, policy):
    """``init_params(place=param_placer(...))`` keeps, leaf for leaf and bit
    for bit, the bands ``shard_tree`` cuts from the whole tree on each
    model rank; the tree drawn on the meta device has the whole tree's
    shapes."""
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    cfg, model = registry.load(arch, smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
    tied = bool(cfg.tie_embeddings)
    whole = model.init_params(0, ccfg, device="cpu")
    meta = model.init_params(0, ccfg, device="meta")
    shapes = lambda tree: [(p, tuple(t.shape), t.dtype) for p, t in T.leaves_with_paths(tree)]
    assert shapes(meta) == shapes(whole)
    banded = 0
    for m in range(2):
        mesh = StubRank(m)
        cut = tshd.shard_tree(whole, tshd.placed_param_specs(meta, mesh, policy, tied), mesh)
        got = model.init_params(0, ccfg, device="cpu",
                                place=tshd.param_placer(mesh, policy, tied))
        for (pw, w), (pg, g) in zip(T.leaves_with_paths(cut), T.leaves_with_paths(got),
                                    strict=True):
            assert pw == pg and torch.equal(w, g), (arch, policy, m, pw)
        banded += sum(c.shape != w.shape for c, w in zip(T.leaves(cut), T.leaves(whole)))
    assert banded > 0, (arch, policy)


@pytest.mark.parametrize("model_size", [1, 2])
@pytest.mark.parametrize("arch", sorted(registry.FAMILY_SMOKE.values()) + ["qwen2.5-32b"])
def test_kv_head_bands_are_the_head_bands_of_cache_specs(arch, model_size):
    """The cache bands a mesh engine places are ``cache_specs``'s bands of
    the k/v heads and nothing else (no T, latent or state band, no data
    axis), and none on a model axis of one rank."""
    _, model = registry.load(arch, smoke=True)
    mesh = type("M", (), {"shape": {"data": 2, "model": model_size}})()
    cache = model.init_cache(4, 16, device="meta")
    full = dict(_flat(tshd.cache_specs(cache, mesh, batch_axes=())))
    leaves = dict(_flat(cache))
    for p, spec in _flat(tshd.kv_head_bands(cache, mesh)):
        head = leaves[p].ndim - 2
        for i, name in enumerate(spec):
            keep = model_size > 1 and p[-1] in ("k", "v") and i == head
            assert name == (full[p][i] if keep else None), (arch, p, spec, full[p])


def test_mesh_engine_takes_whole_or_placed_params_and_refuses_others():
    """A mesh engine cuts whole params to its bands and takes params drawn
    through ``param_placer`` as they are (the same bands, bit for bit);
    params of any other shape raise. (Building an engine makes no
    collective, so one rank of a stub mesh will do.)"""
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    cfg, model = registry.load(registry.FAMILY_SMOKE["transformer"], smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
    mesh = StubRank(1)
    whole = model.init_params(0, ccfg, device="cpu")
    placed = model.init_params(0, ccfg, device="cpu", place=tshd.param_placer(mesh, "cascade"))
    scfg = ServeConfig(max_batch=2, max_len=16)
    a = ServeEngine(model, whole, ccfg, scfg, mesh=mesh, device="cpu")
    b = ServeEngine(model, placed, ccfg, scfg, mesh=mesh, device="cpu")
    assert b.params is placed
    pairs = list(zip(T.leaves(a.params), T.leaves(b.params), T.leaves(whole)))
    assert all(torch.equal(x, y) for x, y, _ in pairs)
    assert any(x.shape != w.shape for x, _, w in pairs)
    half = dict(whole, embed={"table": whole["embed"]["table"][:, :8]})
    with pytest.raises(ValueError, match="neither the whole"):
        ServeEngine(model, half, ccfg, scfg, mesh=mesh, device="cpu")
