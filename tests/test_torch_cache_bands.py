"""The cache's model bands of the reference's ``cache_specs`` (the dry
run's placement) carried through the port's decode step, on the CPU.

One spawned gloo world of four ranks on a (1, 4) mesh
(``tests/_torch_mesh_ranks.band_checks``) decodes four families at smoke
size with the params on their cascade bands and the prefill's cache cut by
the whole of ``cache_specs``:

* qwen2-vl-2b: 2 KV heads on a 4-wide axis, so the k/v cache's time band;
* recurrentgemma-2b: its one-head ring's time band, and the RG-LRU's ``h``
  and conv channels;
* deepseek-v2-236b: MLA's ``c_kv``/``k_rope`` rows;
* mamba2-370m: the SSD state's heads and the conv channels.

Each runs a prefill of 12 positions and 8 decode steps, and is held to the
port's unsharded run of the same inputs:

* a state band (heads, channels) is bit-equal: mamba2-370m's logits and
  cache, bit for bit;
* a time band merges the bands' attentions by their log-sum-exps in
  another order than the unsharded softmax sums: logits within
  ``TIME_BAND_TOL`` (f32 atol/rtol 1e-5; measured up to 3e-6 here);
* the cache gathered whole equals the unsharded cache bit for bit at a
  depth where no banded attention runs before a cache write (qwen2-vl-2b
  and deepseek-v2-236b at one layer, recurrentgemma-2b at its first (R, R,
  A) group): every row a step writes is then computed from the unsharded
  bits. At the smoke configs' whole depth the later layers' rows inherit
  the merge's rounding and the cache is held within ``TIME_BAND_TOL``;
* every banded leaf holds 1/4 of its bytes on each rank.

The same inputs through the JAX reference's prefill and decode steps (f32)
give logits within ``TOL`` (1e-4, as the port's other model tests). The
world also traces the dry run's smoke cell with real tensors, whose
counted collectives the fake world's must equal, a training step's
gradients on the mesh under both policies (the differentiable collectives)
within 1e-5 of the unsharded ones, and the dry run's train step (the
gradient mean and the clip's norm over the bands) against the unsharded
step.
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers as L
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
TIME_BAND_TOL = dict(atol=1e-5, rtol=1e-5)
J_CCFG = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
B, PROMPT, STEPS, MAX_LEN = 2, 12, 8, 32
#: variant -> (arch, layers, config overrides); "cut" variants put no
#: banded attention before a cache write
VARIANTS = {
    "qwen2-vl-2b@cut": ("qwen2-vl-2b", 1, {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", None, {}),
    "recurrentgemma-2b@cut": ("recurrentgemma-2b", 3, {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", None, {}),
    "deepseek-v2-236b@cut": ("deepseek-v2-236b", 1, {"first_dense_layers": 0}),
    "deepseek-v2-236b": ("deepseek-v2-236b", None, {}),
    "mamba2-370m": ("mamba2-370m", None, {}),
}
MODEL_BANDS = {"qwen2-vl-2b": {"k": -3, "v": -3},
               "recurrentgemma-2b": {"k": -3, "v": -3, "h": -1, "conv": -1},
               "deepseek-v2-236b": {"c_kv": -2, "k_rope": -2},
               "mamba2-370m": {"state": -3, "conv": -1}}
SMOKE_CELL = {"arch": "qwen2-vl-2b", "shape": ShapeConfig("smoke_decode", 32, 4, "decode"),
              "tp_policy": "megatron"}


def _jax_cfg(name: str):
    arch, layers, over = VARIANTS[name]
    cfg = jregistry.get_config(arch, smoke=True)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, **over)


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """Each variant's reference params (f32) and its prompt and decode
    inputs, numpy, from seeds."""
    rng = np.random.default_rng(0)
    bands = {}
    for name in VARIANTS:
        cfg = _jax_cfg(name)
        jp = jregistry.build_model(cfg).init_params(jax.random.PRNGKey(0), J_CCFG)
        n = PROMPT + STEPS
        inp = {"arch": VARIANTS[name][0], "n_layers": cfg.n_layers,
               "first_dense_layers": cfg.first_dense_layers,
               "params": jax.tree.map(np.asarray, jp),
               "prompt_len": PROMPT, "steps": STEPS, "max_len": MAX_LEN}
        if cfg.input_embeds:
            inp["embeds"] = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
            inp["positions"] = np.broadcast_to(np.arange(n, dtype=np.int32), (3, B, n)).copy()
        else:
            inp["tokens"] = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
        bands[name] = inp
    train = rng.integers(0, 256, (4, 17)).astype(np.int32)
    return {"bands": bands, "cell": SMOKE_CELL, "train_tokens": train}


@pytest.fixture(scope="module")
def world():
    return meshlib.run_local_ranks(4, R.band_checks, (1, 4), inputs(), timeout=600)


def _unequal_leaves(a: dict, b: dict) -> list:
    return [k for k in a if not np.array_equal(a[k], b[k])]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_every_band_of_cache_specs_is_placed(world, name):
    """The model bands the policy reads are the family's bands of
    ``cache_specs``, and each banded leaf holds a quarter of its bytes on
    every rank (``pos``/``slot_pos`` stay whole, as the reference places
    them)."""
    arch = VARIANTS[name][0]
    for r in world:
        res = r[name]
        assert res["model_bands"] == MODEL_BANDS[arch], (name, res["model_bands"])
        for leaf, (local, whole, spec) in res["bytes"].items():
            banded = "model" in spec
            assert local * (4 if banded else 1) == whole, (name, leaf, local, whole, spec)
            assert banded == (leaf.split("/")[-1] in MODEL_BANDS[arch]), (name, leaf, spec)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_banded_decode_matches_the_unsharded_step(world, name):
    """State bands bit for bit; time bands within ``TIME_BAND_TOL``; the
    gathered cache bit-equal to the unsharded one where no banded attention
    precedes a write (the ``@cut`` depths and Mamba-2), else within the
    same tolerance."""
    arch = VARIANTS[name][0]
    time_band = any(MODEL_BANDS[arch].get(k) in (-3, -2) and k in ("k", "c_kv")
                    for k in MODEL_BANDS[arch])
    for r in world:
        res = r[name]
        assert len(res["got"]) == STEPS + 1
        for want, got in zip(res["want"], res["got"]):
            if time_band:
                np.testing.assert_allclose(got, want, **TIME_BAND_TOL)
            else:
                assert np.array_equal(got, want), name
        if name.endswith("@cut") or not time_band:
            assert not _unequal_leaves(res["cache_want"], res["cache_got"]), \
                (name, _unequal_leaves(res["cache_want"], res["cache_got"]))
        else:
            for k in res["cache_want"]:
                np.testing.assert_allclose(res["cache_got"][k], res["cache_want"][k],
                                           **TIME_BAND_TOL)
    assert all(np.array_equal(a, b) for r in world[1:]
               for a, b in zip(r[name]["got"], world[0][name]["got"])), name


@pytest.mark.parametrize("name", list(VARIANTS))
def test_banded_decode_matches_the_reference(world, name):
    """The JAX reference's prefill and decode steps at f32 on the same
    params and inputs."""
    cfg = _jax_cfg(name)
    jm = jregistry.build_model(cfg)
    inp = inputs()["bands"][name]
    jp = jax.tree.map(jnp.asarray, inp["params"])

    def batch(lo, hi):
        if "embeds" in inp:
            return {"inputs_embeds": jnp.asarray(inp["embeds"][:, lo:hi]),
                    "positions": jnp.asarray(inp["positions"][:, :, lo:hi])}
        return {"tokens": jnp.asarray(inp["tokens"][:, lo:hi])}

    logits, cache = jm.prefill(jp, batch(0, PROMPT), J_CCFG, max_len=MAX_LEN)
    want = [np.asarray(logits)]
    step = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, J_CCFG))
    for j in range(STEPS):
        logits, cache = step(jp, batch(PROMPT + j, PROMPT + j + 1), cache)
        want.append(np.asarray(logits))
    for w, g in zip(want, world[0][name]["got"]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("full_dp", [False, True], ids=["model-replicated-rows", "full-dp"])
@pytest.mark.parametrize("policy", ["cascade", "megatron"])
def test_training_gradients_on_a_mesh_match_unsharded(world, policy, full_dp):
    """A loss and its gradients with the params on their bands (the
    all-gather's gradient the rank's band, a band input's gradient summed
    over the model ranks) equal the unsharded ones within 1e-5; under full
    data parallelism (each model rank its own rows, the banded params
    gathered whole, their gradients summed back onto the band) too,
    averaged over the ranks."""
    res = world[0][("train", policy, full_dp)]
    assert res["loss"][1] == pytest.approx(res["loss"][0], abs=1e-5)
    for want, got in res["grads"]:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("full_dp", [False, True], ids=["model-replicated-rows", "full-dp"])
@pytest.mark.parametrize("policy", ["cascade", "megatron"])
def test_train_step_on_a_mesh_matches_unsharded(world, policy, full_dp):
    """One step of the dry run's train cell on the rank's bands (the
    gradients averaged over the data shards, the clip's norm taken over the
    whole gradients: the banded leaves' squares all-reduced over model)
    against ``make_train_step`` on the whole params: the gradient norm
    within 1e-5; the AdamW moments (each scaled by the clip) and the updated
    params, gathered whole, within 1e-5 and 1e-7 (the step moves a param by
    about 3e-6)."""
    res = world[0][("step", policy, full_dp)]
    assert res["gnorm"][1] == pytest.approx(res["gnorm"][0], rel=1e-5)
    for key, atol in (("mu", 1e-5), ("nu", 1e-5), ("params", 1e-7)):
        for want, got in res[key]:
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5, err_msg=key)


def test_fake_world_collectives_equal_a_gloo_world(world):
    """The dry run's smoke cell (qwen2-vl-2b decode, megatron, its cache's
    time band) on rank 0 of a fake world of four counts the collectives a
    real four-rank gloo world's rank 0 makes on the same step."""
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((1, 4), ("data", "model"))
        rec = dryrun.run_cell(SMOKE_CELL["arch"], SMOKE_CELL["shape"], mesh,
                              tp_policy=SMOKE_CELL["tp_policy"], verbose=False,
                              cfg=registry.get_config(SMOKE_CELL["arch"], smoke=True))
    got = world[0]["cell_collectives"]
    assert got["all_reduce_sum"]["calls"] > 0 and got["all_gather"]["calls"] > 0
    assert rec["collectives"] == dryrun._collective_record(got)


# ---------------------------------------------------------------------------
# the log-sum-exp and the merge
# ---------------------------------------------------------------------------

def _attn_inputs(b, hq, hkv, t, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hq, d, generator=g), torch.randn(b, t, hkv, d, generator=g),
            torch.randn(b, t, hkv, d, generator=g))


@pytest.mark.parametrize("b,hq,hkv,t,d", [(3, 8, 2, 64, 16), (2, 10, 1, 48, 32), (1, 4, 4, 16, 8)])
@pytest.mark.parametrize("live", ["all", "q_pos", "mask"])
def test_decode_attention_lse_is_the_logsumexp_of_live_scores(b, hq, hkv, t, d, live):
    """``return_lse``: the output is the call's without it, and lse the
    ``torch.logsumexp`` of each row's live scaled scores (-inf for a row
    with none)."""
    q, k, v = _attn_inputs(b, hq, hkv, t, d)
    scale = d ** -0.5
    mask = q_pos = None
    alive = torch.ones(b, t, dtype=torch.bool)
    if live == "q_pos":
        q_pos = torch.tensor([(i * 13) % t for i in range(b)], dtype=torch.int32)
        alive = torch.arange(t)[None] <= q_pos[:, None]
    elif live == "mask":
        mask = torch.rand(b, t, generator=torch.Generator().manual_seed(1)) > 0.5
        mask[0] = False                                   # a row with no live key
        alive = mask
    o, lse = decode_attention_plain(q, k, v, mask, scale, q_pos, return_lse=True)
    assert torch.equal(o, decode_attention_plain(q, k, v, mask, scale, q_pos))
    s = torch.einsum("bhd,bthd->bht", q, k.repeat_interleave(hq // hkv, dim=2)) * scale
    want = torch.logsumexp(s.masked_fill(~alive[:, None], float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
    if live == "mask":
        assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()


@pytest.mark.parametrize("bands", [2, 4, 8])
@pytest.mark.parametrize("pos", [[0, 5], [31, 63], [17, 40]])
def test_band_merge_equals_attention_over_the_whole_cache(bands, pos):
    """Each band's (o, lse) by ``decode_attention_plain`` over its rows,
    merged in rank order (``sharding.merge_time_bands``), against the one
    call over every row: within 1e-6 (another summation order); a band
    past the row's position has no live key and weighs 0."""
    q, k, v = _attn_inputs(2, 8, 2, 64, 16, seed=3)
    q_pos = torch.tensor(pos, dtype=torch.int32)
    whole = decode_attention_plain(q, k, v, q_pos=q_pos)
    tb = 64 // bands
    parts = []
    for r in range(bands):
        o, lse = decode_attention_plain(q, k[:, r * tb:(r + 1) * tb], v[:, r * tb:(r + 1) * tb],
                                        q_pos=q_pos - r * tb, return_lse=True)
        parts.append(torch.cat([o, lse[..., None]], dim=-1))
    torch.testing.assert_close(sharding.merge_time_bands(torch.stack(parts)), whole,
                               atol=1e-6, rtol=1e-6)


def test_band_softmax_weighs_a_band_without_live_keys_zero():
    logits = torch.randn(2, 3, 5)
    live = torch.ones(2, 3, 5, dtype=torch.bool)
    live[1] = False
    p, lse = L.band_softmax(logits, live)
    torch.testing.assert_close(p[0], torch.softmax(logits[0], dim=-1))
    assert torch.equal(p[1], torch.zeros(3, 5)) and torch.isneginf(lse[1]).all()


# ---------------------------------------------------------------------------
# the limits: only decode runs on a cache with a band other than the heads'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "recurrentgemma-2b", "deepseek-v2-236b",
                                  "mamba2-370m"])
def test_extend_on_a_banded_cache_raises_naming_the_limit(arch):
    """``prefill_extend`` (and so the speculative verify pass) on a cache
    placed by the whole ``cache_specs`` raises ``ValueError`` before any
    collective (a fake world of four, in this process). The dense smoke
    model takes 2 KV heads, so its cache holds a time band (qwen2-vl-2b's
    M-RoPE refuses extend on its own)."""
    cfg = registry.get_config(arch, smoke=True)
    if cfg.family == "dense":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    model = registry.build_model(cfg)
    ccfg = R.CCFG
    params = model.init_params(0, ccfg, device="cpu")
    cache = model.init_cache(2, MAX_LEN, dtype=torch.float32, device="cpu")
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((1, 4), ("data", "model"))
        specs = sharding.cache_specs(cache, mesh)
        band = sharding.shard_tree(cache, specs, mesh)
        pol = sharding.ActivationPolicy(mesh, "cascade", cache_bands=specs)
        batch = ({"inputs_embeds": torch.zeros(2, 3, cfg.d_model)} if cfg.input_embeds
                 else {"tokens": torch.zeros(2, 3, dtype=torch.int32)})
        with sharding.activation_policy(pol), pytest.raises(ValueError, match="decode only"):
            model.prefill_extend(params, batch, band, ccfg)
