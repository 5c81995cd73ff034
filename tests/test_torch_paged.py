"""The port's paged KV pool and radix prefix cache against the JAX package.

* The pool primitives (``cache_utils.paged_*``, ``reset_slot_pos``) equal
  the reference's exactly on every page but the trash page 0, where several
  writes of one call may land on one row (CUDA keeps an arbitrary one).
* ``PagePool``/``RadixPrefixCache`` are integer bookkeeping: the same
  pages, matched lengths, refcounts and evictions as the reference's over
  seeded random sequences of insert, match and evict.
* The paged branch of ``attn_apply`` equals the port's dense branch bit for
  bit (rows backed by the trash page get weight exactly 0), on the plain
  route and on the kernel route (the kernels' plain versions on the CPU).
* The paged model steps agree with the JAX paged steps at f32 on carried
  weights (atol/rtol 1e-4, as ``test_torch_transformer.py``: RoPE, softmax
  and matmul sums run in another order on the two sides).
* The paged engine emits the JAX paged engine's greedy and speculative
  greedy streams token for token, with the same prefix hits, lookups and
  evictions, and the port's own dense engine's streams (sampled ones too).
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _hypothesis_shim import given, settings, strategies as st

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import cache_utils as jcache
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro.serve import prefix as jprefix
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import cache_utils as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import registry
from repro_torch.serve import engine as tengine
from repro_torch.serve import prefix as tprefix

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
T_TRAIN = CascadeConfig(mode="train", compute_dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# the pool primitives
# ---------------------------------------------------------------------------

PS = 4
#: (B, nb) = (3, 4): slot 0 fully backed, slot 1 with its last two blocks
#: unbacked, slot 2 free (a zeroed row); pages 7, 8 and 9 mapped by no slot
BT = np.array([[3, 1, 6, 2], [5, 4, 0, 0], [0, 0, 0, 0]], np.int32)
NUM_PAGES = 10


def _pool(seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(lead + (NUM_PAGES, PS, 2, 3)).astype(np.float32)


def test_paged_phys_rows_equal_the_reference_past_capacity_and_unbacked():
    rows = np.array([[0, 5, 15, 16, 40], [3, 7, 8, 13, 17], [0, 1, 2, 3, 99]], np.int32)
    want = np.asarray(jcache.paged_phys_rows(jnp.asarray(BT), jnp.asarray(rows), PS))
    got = tcache.paged_phys_rows(_t(BT), _t(rows), PS)
    np.testing.assert_array_equal(got.numpy(), want)
    # rows 16 and 40 are past capacity, slot 1's rows 8.. are unbacked, slot
    # 2 has no page: all of them land on the trash page
    assert (got[0, 3:] < PS).all() and (got[1, 2:] < PS).all() and (got[2] < PS).all()


def test_paged_gather_equals_the_reference():
    pool = _pool(0)
    want = jcache.paged_gather(jnp.asarray(pool), jnp.asarray(BT), PS)
    got = tcache.paged_gather(_t(pool), _t(BT), PS)
    assert got.shape == (3, BT.shape[1] * PS, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos,s", [([2, 1, 0], 3), ([13, 6, 9], 5), ([15, 7, 30], 2)])
def test_paged_update_rows_equals_the_reference_and_spares_live_pages(pos, s):
    """Writes through the table (some past capacity, some into unbacked
    blocks or a free slot's zeroed row, so several land on one trash row)
    equal the reference's on every page but the trash page, and no write
    lands on a page no slot maps."""
    pool = _pool(1)
    new = np.random.default_rng(2).standard_normal((3, s, 2, 3)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jcache.paged_update_rows(jnp.asarray(pool), jnp.asarray(new),
                                               jnp.asarray(BT), jnp.asarray(pos), PS))
    got = _t(pool)
    rows = _t(pos).to(torch.int64)[:, None] + torch.arange(s)
    tcache.paged_update_rows(got, _t(new), tcache.paged_phys_rows(_t(BT), rows, PS))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(got.numpy()[7:], pool[7:])     # unmapped pages untouched


@pytest.mark.parametrize("s", [1, 5])
def test_paged_rows_snapshot_and_restore_equal_the_reference(s):
    """A layer-stacked (L = 2) paged cache: the snapshot equals the
    reference's on every row not mapped to the trash page (into ``out``,
    allocated once, too), and the restore gives the reference's pools on
    every page but the trash page and its rewound ``pos``."""
    pools = {n: _pool(3 + i, lead=(2,)) for i, n in enumerate(("k", "v"))}
    pos = np.array([[2, 6, 0], [2, 6, 0]], np.int32)
    jc = {**{n: jnp.asarray(p) for n, p in pools.items()}, "pos": jnp.asarray(pos)}
    tc = {**{n: _t(p) for n, p in pools.items()}, "pos": _t(pos)}
    jsnap = jcache.paged_rows_snapshot(jc, jnp.asarray(BT), s)
    tsnap = tcache.paged_rows_snapshot(tc, _t(BT), s)
    out = {n: torch.full_like(v, -7.0) for n, v in tsnap.items()}
    filled = tcache.paged_rows_snapshot(tc, _t(BT), s, out=out)
    assert all(filled[n] is out[n] for n in out)
    rows = pos[..., None] + np.arange(s)
    live = np.asarray(jcache.paged_phys_rows(jnp.asarray(np.broadcast_to(BT, (2,) + BT.shape)),
                                             jnp.asarray(rows), PS)) >= PS
    for snap in (tsnap, out):
        np.testing.assert_array_equal(snap["pos"].numpy(), pos)
        for n in pools:
            np.testing.assert_array_equal(snap[n].numpy()[live], np.asarray(jsnap[n])[live])
    # the verify pass overwrites the rows; the rewind keeps keep[b] of them
    rng = np.random.default_rng(4)
    written = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in pools.items()}
    keep = np.array([1, min(2, s), 0], np.int32)
    jafter = jcache.paged_rows_restore(
        {**{n: jnp.asarray(w) for n, w in written.items()}, "pos": jnp.asarray(pos + s)},
        jsnap, jnp.asarray(BT), jnp.asarray(keep))
    tafter = {**{n: _t(w) for n, w in written.items()}, "pos": _t(pos + s)}
    assert tcache.paged_rows_restore(tafter, tsnap, _t(BT), _t(keep)) is tafter
    np.testing.assert_array_equal(tafter["pos"].numpy(), np.asarray(jafter["pos"]))
    for n in pools:
        np.testing.assert_array_equal(tafter[n].numpy()[:, 1:], np.asarray(jafter[n])[:, 1:])


def test_reset_slot_pos_equals_the_reference():
    cache = {"layers": {"k": np.zeros((2, 5, PS, 1, 2), np.float32),
                        "pos": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    want = jcache.reset_slot_pos(jax.tree.map(jnp.asarray, cache), 1, 8)
    got = {"layers": {n: _t(v) for n, v in cache["layers"].items()}}
    assert tcache.reset_slot_pos(got, 1, 8) is got
    np.testing.assert_array_equal(got["layers"]["pos"].numpy(), np.asarray(want["layers"]["pos"]))
    np.testing.assert_array_equal(got["layers"]["k"].numpy(), cache["layers"]["k"])


# ---------------------------------------------------------------------------
# the allocator and the radix tree
# ---------------------------------------------------------------------------

class _Side:
    """One package's pool and tree, with a COW hook that allocates the copy
    (and, as the engine does, skips the match when the pool is full)."""

    def __init__(self, mod, num_pages, ps):
        self.pool = mod.PagePool(num_pages)

        def cow(src):
            return self.pool.alloc() if self.pool.free_pages else None

        self.tree = mod.RadixPrefixCache(self.pool, ps, copy_page=cow)

    def state(self):
        return (self.pool.refcount.tolist(), list(self.pool._free), self.tree.evictions)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 4))
def test_pool_and_tree_equal_the_reference_over_random_operations(seed, ps):
    """Seeded random inserts (a slot's pages allocated, published, then
    released at retire), matches (with copy-on-write tails; the matched
    pages released again) and evictions, in lockstep on both packages: the
    same pages, matched lengths, hits, refcounts, free lists and evictions
    after every operation."""
    rng = np.random.default_rng(seed)
    ref, port = _Side(jprefix, 24, ps), _Side(tprefix, 24, ps)
    for _ in range(60):
        op = rng.integers(0, 4)
        prompt = [int(t) for t in rng.integers(0, 3, rng.integers(1, 4 * ps))]
        if op == 0:
            n_full = len(prompt) // ps
            if ref.pool.free_pages < n_full:
                continue
            got = []
            for side in (ref, port):
                pages = [side.pool.alloc() for _ in range(n_full)]
                got.append((pages, side.tree.insert(prompt, pages)))
                for pg in pages:
                    side.pool.release(pg)
            assert got[0] == got[1]
        elif op in (1, 2):
            m = [side.tree.match(prompt) for side in (ref, port)]
            assert [(x.pages, x.matched, x.hit_full, x.cow) for x in m] == \
                [(m[0].pages, m[0].matched, m[0].hit_full, m[0].cow)] * 2
            for side, x in zip((ref, port), m):
                for pg in x.pages:
                    side.pool.release(pg)
        else:
            n = int(rng.integers(0, 6))
            assert ref.tree.evict(n) == port.tree.evict(n)
            w = int(rng.integers(0, 24))
            assert ref.tree.maybe_evict(w) == port.tree.maybe_evict(w)
        assert ref.state() == port.state()


# ---------------------------------------------------------------------------
# the paged attention branch against the dense branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode,s,n_valid", [("decode", 1, None), ("extend", 5, 3)])
def test_paged_attention_equals_the_dense_branch_bit_for_bit(use_kernel, mode, s, n_valid):
    """Three slots at positions 0, 6 and 11 of a 4-block, 16-row cache (the
    pages a permutation of the pool, slot 0's last two blocks unbacked): the
    paged branch writes the dense branch's rows and returns its output bit
    for bit, though the rows above each slot's position hold other garbage
    on the two sides. The kernel route's extend attends over the gathered
    blocks covering ``kv_len`` (cut to it), as the dense one over the
    cache's first ``kv_len`` rows."""
    cfg = tlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    params = tlayers.attn_init(torch.Generator().manual_seed(0), cfg, T_TRAIN, device="cpu")
    ccfg = CascadeConfig(mode="train", compute_dtype=torch.float32, use_kernel=use_kernel)
    rng = np.random.default_rng(5)
    b, nb, ps, pages = 3, 4, 4, 14
    x = torch.from_numpy(rng.standard_normal((b, s, 32)).astype(np.float32))
    pos = np.array([0, 6, 11], np.int32)
    bt = 1 + rng.permutation(pages - 1)[:b * nb].reshape(b, nb).astype(np.int32)
    bt[0, 2:] = 0
    kv = rng.standard_normal((2, b, nb * ps, 2, 8)).astype(np.float32)
    dense = {"k": _t(kv[0]), "v": _t(kv[1]), "pos": _t(pos)}
    pool = rng.standard_normal((2, pages, ps, 2, 8)).astype(np.float32)
    for i in range(b):                      # the slots' written rows, in their pages
        for j in range(nb):
            if bt[i, j] and j * ps < pos[i]:
                pool[:, bt[i, j]] = kv[:, i, j * ps:(j + 1) * ps]
    paged = {"k": _t(pool[0]), "v": _t(pool[1]), "pos": _t(pos), "block_table": _t(bt)}
    kw = dict(mode=mode, n_valid=n_valid,
              kv_len=int(pos.max()) + s if mode == "extend" else None)
    want, wc = tlayers.attn_apply(params, x, cfg, ccfg, dense, **kw)
    got, gc = tlayers.attn_apply(params, x, cfg, ccfg, paged, **kw)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(gc["pos"].numpy(), wc["pos"].numpy())
    for name in ("k", "v"):
        view = tcache.paged_gather(gc[name], gc["block_table"], ps)
        for i in range(b):
            backed = int((bt[i] > 0).sum()) * ps
            end = min(pos[i] + s, backed)
            assert torch.equal(view[i, :end], wc[name][i, :end])


# ---------------------------------------------------------------------------
# the paged model steps against the JAX paged steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def codeqwen():
    """codeqwen at smoke size: the reference's FP4 params and the port's
    copy of them, leaf by leaf."""
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jp = jcascade.tree_to_serve_fp4(jm.init_params(jax.random.PRNGKey(0), J_TRAIN), J_FP4)
    _, tm = registry.load("codeqwen1.5-7b", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def test_paged_model_steps_match_jax(codeqwen):
    """Two slots over a shared 9-page pool (page 4, 16 rows a slot): a padded
    extend chunk at positions 0 and 3 (``n_valid`` per slot), a decode step,
    then a speculative verify chunk and its rewind. Logits agree at f32, the
    pools on every page but the trash page, ``pos`` exactly; the checkpoint
    carries the table it wrote through."""
    cfg, jm, jp, tm, tp = codeqwen
    ps, npages = 4, 9
    bt = np.array([[2, 5, 7, 0], [1, 8, 3, 6]], np.int32)
    jc = jm.init_paged_cache(2, npages, ps, dtype=jnp.float32)
    tc = tm.init_paged_cache(2, npages, ps, dtype=torch.float32, device="cpu")
    jc = {"layers": {**jc["layers"], "pos": jnp.asarray([[0, 3]] * cfg.n_layers, jnp.int32)}}
    tc["layers"]["pos"].copy_(torch.tensor([[0, 3]] * cfg.n_layers, dtype=torch.int32))
    rng = np.random.default_rng(6)

    def both(jfn, tfn, toks, **kw):
        jb = {"tokens": jnp.asarray(toks), "block_table": jnp.asarray(bt)}
        tb = {"tokens": _t(toks), "block_table": _t(bt)}
        return jfn(jp, jb, **kw), tfn(tp, tb, **kw)

    def close_cache(tcc, jcc):
        for name in ("k", "v"):
            np.testing.assert_allclose(tcc["layers"][name].numpy()[:, 1:],
                                       np.asarray(jcc["layers"][name])[:, 1:], **TOL)
        np.testing.assert_array_equal(tcc["layers"]["pos"].numpy(),
                                      np.asarray(jcc["layers"]["pos"]))

    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    nv = np.array([6, 4], np.int32)
    (jl, jc), (tl, tc) = both(lambda p, b: jm.prefill_extend(p, b, jc, J_FP4, n_valid=jnp.asarray(nv)),
                              lambda p, b: tm.prefill_extend(p, b, tc, T_FP4, n_valid=_t(nv)),
                              toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    close_cache(tc, jc)
    toks = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    (jl, jc), (tl, tc) = both(lambda p, b: jm.decode_step(p, b, jc, J_FP4),
                              lambda p, b: tm.decode_step(p, b, tc, T_FP4), toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    close_cache(tc, jc)
    toks = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    (jl, jc, jck), (tl, tc, tck) = both(lambda p, b: jm.spec_verify(p, b, jc, J_FP4),
                                        lambda p, b: tm.spec_verify(p, b, tc, T_FP4), toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    close_cache(tc, jc)
    np.testing.assert_array_equal(tck["block_table"].numpy(), bt)
    keep = np.array([2, 1], np.int32)
    jc = jm.spec_rewind(jc, jck, jnp.asarray(keep))
    tc = tm.spec_rewind(tc, tck, _t(keep))
    close_cache(tc, jc)


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

def _shared_reqs(vocab, n=4, prefix_len=24, suffix_len=6, seed=0):
    """n prompts sharing one prefix (the reference's ``_shared_reqs``)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, suffix_len).astype(np.int32)])
            for _ in range(n)]


def _cow_prompts(vocab):
    """Two prompts that part mid-page: 12 shared tokens at page size 8."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, 12).astype(np.int32)
    tails = [rng.integers(0, vocab, 6).astype(np.int32) for _ in range(2)]
    return [np.concatenate([shared, t]) for t in tails]


def _distinct_prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, 30).astype(np.int32) for _ in range(4)]


#: name -> (prompts from the vocab, max_new, ServeConfig options beside the
#: shared max_len 64, prefill_chunk 8, page_size 8): the reference's
#: test_paged.py scenarios that need no ReplicaSet
SCENARIOS = {
    "greedy": (_shared_reqs, 8, dict(max_batch=2, prefix_cache=True)),
    "spec_greedy": (_shared_reqs, 8, dict(max_batch=2, prefix_cache=True, draft_len=3)),
    "paged_only": (_shared_reqs, 8, dict(max_batch=2, paged=True)),
    "cow": (_cow_prompts, 8, dict(max_batch=1, prefix_cache=True)),
    "eviction": (_distinct_prompts, 6, dict(max_batch=1, prefix_cache=True, num_pages=9)),
    "hit_rate": (lambda v: _shared_reqs(v, n=6), 8, dict(max_batch=1, prefix_cache=True)),
}


def _serve(mod, eng, prompts, max_new):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.tokens_out) for r in reqs]


def _engines(models, name, **over):
    cfg, jm, jp, tm, tp = models
    make, max_new, opts = SCENARIOS[name]
    scfg = dict(max_len=64, prefill_chunk=8, page_size=8, fused=True, **opts, **over)
    prompts = make(cfg.vocab)
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**scfg), device="cpu")
    return prompts, max_new, scfg, teng


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_engine_equals_jax_paged_engine(codeqwen, name):
    """Each scenario through the JAX paged engine, the port's paged engine
    and the port's dense engine: equal streams, and the JAX engine's prefix
    hits, lookups and evictions."""
    cfg, jm, jp, tm, tp = codeqwen
    prompts, max_new, scfg, teng = _engines(codeqwen, name)
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    dense = {k: v for k, v in scfg.items()
             if k not in ("paged", "prefix_cache", "num_pages", "page_size")}
    deng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**dense), device="cpu")
    want = _serve(jengine, jeng, prompts, max_new)
    got = _serve(tengine, teng, prompts, max_new)
    assert got == want
    assert _serve(tengine, deng, prompts, max_new) == got
    assert teng.effective_mode == jeng.effective_mode == deng.effective_mode + "-paged"
    assert not teng.downgrades
    tm_, jm_ = teng.metrics(), jeng.metrics()
    for key in ("prefix_hits", "prefix_lookups", "evictions", "pages_total", "steps",
                "decode_tokens"):
        assert tm_[key] == jm_[key], key
    if name in ("greedy", "spec_greedy"):
        assert tm_["prefix_hits"] > 0
    elif name == "paged_only":
        assert teng.prefix is None and tm_["prefix_lookups"] == 0
    elif name == "cow":
        # one full page (8) and a 4-token copy-on-write tail
        assert tm_["prefix_hits"] > 8
    elif name == "eviction":
        assert tm_["evictions"] > 0 and tm_["pages_in_use"] <= tm_["pages_total"]
    elif name == "hit_rate":
        assert tm_["prefix_lookups"] == 6 * 30
        assert tm_["prefix_hit_rate"] >= 0.5 and tm_["pages_in_use"] > 0


def test_admission_after_a_hit_off_the_chunk_keeps_the_dense_chunk_boundaries(codeqwen,
                                                                              monkeypatch):
    """A 12-token hit (3 pages of 4) with chunks of 8: the first chunk after
    it ends at row 16, and every chunk hands attention its dense chunk's
    live keys (a multiple of the chunk, holding its valid rows), so each
    chunk's rows, live keys and flash plan are the dense engine's; the
    streams equal the dense engine's and the JAX paged engine's."""
    cfg, jm, jp, tm, tp = codeqwen
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 13).astype(np.int32)])
               for _ in range(3)]
    scfg = dict(max_batch=1, max_len=48, prefill_chunk=8, fused=True)
    paged = dict(scfg, prefix_cache=True, page_size=4)
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**paged), device="cpu")
    chunks, extend = [], tm.prefill_extend

    def spy(params, batch, cache, ccfg, n_valid=None, kv_len=None, **kw):
        chunks.append((teng._staging.consumed, int(n_valid), kv_len))
        return extend(params, batch, cache, ccfg, n_valid=n_valid, kv_len=kv_len, **kw)
    monkeypatch.setattr(tm, "prefill_extend", spy)
    got = _serve(tengine, teng, prompts, 4)
    monkeypatch.undo()
    assert teng.metrics()["prefix_hits"] == 2 * 12
    assert any(start % 8 for start, _, _ in chunks)          # admission began mid-chunk
    for start, n, kv_len in chunks:
        assert kv_len % 8 == 0 and kv_len - 8 <= start and start + n <= kv_len, chunks
    deng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**scfg), device="cpu")
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**paged))
    assert got == _serve(tengine, deng, prompts, 4) == _serve(jengine, jeng, prompts, 4)


@pytest.mark.parametrize("draft_len", [0, 3])
def test_paged_sampled_streams_equal_the_dense_engines(codeqwen, draft_len):
    """Seeded sampling, plain and speculative: the paged engine's logits are
    the dense engine's and its draws come in the same order from one seed,
    so the streams are equal token for token."""
    cfg, jm, jp, tm, tp = codeqwen
    prompts, max_new, scfg, teng = _engines(codeqwen, "greedy", temperature=0.7, top_k=8,
                                            draft_len=draft_len)
    dense = {k: v for k, v in scfg.items() if k not in ("prefix_cache", "page_size")}
    deng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**dense), device="cpu")
    assert _serve(tengine, teng, prompts, max_new) == _serve(tengine, deng, prompts, max_new)
    assert teng.effective_mode.endswith("-sampled-fused-paged")


def test_paged_metrics_keys(codeqwen):
    prompts, max_new, scfg, teng = _engines(codeqwen, "greedy")
    _serve(tengine, teng, prompts[:2], 2)
    m = teng.metrics()
    assert m["paged"] is True and m["prefix_cache"] is True
    for k in ("prefix_hit_rate", "pages_in_use", "pages_total", "evictions", "page_size",
              "prefix_hits", "prefix_lookups"):
        assert k in m, k
    assert m["page_size"] == 8 and m["pages_total"] == 2 * 8
    assert m["effective_mode"] == "batched-greedy-fused-paged"


def test_mamba2_downgrades_to_the_dense_cache_like_jax():
    """Mamba-2's recurrent state has no page layout: both engines warn,
    report an un-suffixed mode and serve the same streams."""
    cfg, jm = jregistry.load("mamba2-370m", smoke=True)
    jp = jcascade.tree_to_serve_fp4(jm.init_params(jax.random.PRNGKey(0), J_TRAIN), J_FP4)
    _, tm = registry.load("mamba2-370m", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    scfg = dict(max_batch=2, max_len=64, prefill_chunk=8, page_size=8, prefix_cache=True,
                fused=True)
    prompts = _shared_reqs(cfg.vocab, n=2)
    streams = []
    for mod, eng in ((jengine, lambda: jengine.ServeEngine(jm, jp, J_FP4,
                                                           jengine.ServeConfig(**scfg))),
                     (tengine, lambda: tengine.ServeEngine(tm, tp, T_FP4,
                                                           tengine.ServeConfig(**scfg),
                                                           device="cpu"))):
        with pytest.warns(RuntimeWarning, match="paged KV requested"):
            e = eng()
        assert not e.paged and e.prefix is None
        assert e.effective_mode == "batched-greedy-fused"
        assert any("paged" in d for d in e.downgrades)
        streams.append(_serve(mod, e, prompts, 4))
    assert streams[0] == streams[1]
