"""The modality-stub backbones of the port against the JAX package.

qwen2-vl-2b (M-RoPE over (t, h, w) positions) and musicgen-large
(sinusoidal positions, a multi-codebook head) both take the stub
frontends' embeddings (``inputs_embeds``). The same inputs, drawn from a
seed with numpy, go through the JAX ``TransformerLM`` and the port's on the
reference's own params (carried across by ``convert.params_from_numpy``):
logits and caches agree at atol/rtol 1e-4 in f32 (RoPE, softmax and matmul
sums run in another order on the two sides); ``apply_mrope`` at atol 1e-5;
``sinusoidal_positions`` (bf16 out) within one bf16 step of each value.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import registry
from repro_torch.models.transformer import TransformerLM

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
ROPE_TOL = dict(atol=1e-5, rtol=1e-5)
J = {"train": JCascadeConfig(mode="train", compute_dtype=jnp.float32),
     "serve_fp4": JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)}
T = {"train": CascadeConfig(mode="train", compute_dtype=torch.float32),
     "serve_fp4": CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)}
ARCHS = ("qwen2-vl-2b", "musicgen-large")
B, S, DECODES = 2, 12, 3


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def vl_positions(b: int, t: int, h: int, w: int, n_text: int) -> np.ndarray:
    """(3, B, t*h*w + n_text) int32: an image of t x h x w patches at its
    (t, h, w) grid positions, then text continuing from the grid's largest
    position + 1 in all three streams, as Qwen2-VL numbers them."""
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([tt.ravel(), hh.ravel(), ww.ravel()])
    text = img.max() + 1 + np.arange(n_text)
    pos = np.concatenate([img, np.broadcast_to(text, (3, n_text))], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(np.int32).copy()


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS for m in ("train", "serve_fp4")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, mode = request.param
    cfg, jm = jregistry.load(arch, smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0), J["train"])
    if mode == "serve_fp4":
        jp = jcascade.tree_to_serve_fp4(jp, J["serve_fp4"])
    _, tm = registry.load(arch, smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp, mode


def _inputs(cfg, seed=0):
    """Embeddings (B, S + DECODES, d) f32 and, for M-RoPE, positions: an
    image of 1 x 2 x 3 patches, then text."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, S + DECODES, cfg.d_model)).astype(np.float32)
    pos = vl_positions(B, 1, 2, 3, S + DECODES - 6) if cfg.mrope_sections else None
    return emb, pos


def _batch(emb, pos, lo, hi, torch_side: bool, pos_offset=None):
    conv = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if torch_side else jnp.asarray
    batch = {"inputs_embeds": conv(emb[:, lo:hi])}
    if pos is not None:
        batch["positions"] = conv(pos[:, :, lo:hi])
    if pos_offset is not None:
        batch["pos_offset"] = pos_offset
    return batch


@pytest.mark.parametrize("sections", [(2, 3, 3), (4, 1, 3), (1, 1, 1, 2, 3)])
def test_apply_mrope_matches_jax(sections):
    """Image-grid then text positions; the bands split unevenly, and (five
    sections) band i rotated by stream i % 3."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 10, 3, 16)).astype(np.float32)
    pos = vl_positions(B, 2, 2, 1, 6)
    inv = np.asarray(jlayers.rope_freqs(16, 1e6))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv), sections)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              tlayers.rope_freqs(16, 1e6), sections)
    _close(got, want, ROPE_TOL)


def test_rope_passes_every_channel_through_without_rotary():
    """rope_fraction 0 (musicgen): an empty inv_freq, no 0/0, x unchanged."""
    inv = tlayers.rope_freqs(16, 1e4, 0.0)
    assert inv.numel() == 0
    x = torch.randn(B, 5, 4, 16)
    out = tlayers.apply_rope(x, torch.arange(5)[None].expand(B, 5), inv)
    assert torch.equal(out, x)


@pytest.mark.parametrize("offset", [0, 37])
@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_positions_match_jax(offset, d):
    want = np.asarray(jlayers.sinusoidal_positions(16, d, offset)).astype(np.float32)
    got = tlayers.sinusoidal_positions(16, d, offset).to(torch.float32).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_registry_builds_both_stub_backbones_with_their_trees(pair):
    """No ``embed`` leaf; an untied head ``vocab * max(1, n_codebooks)``
    wide, carried across from the reference's tree."""
    cfg, _, jp, tm, tp, _ = pair
    assert isinstance(tm, TransformerLM)
    assert "embed" not in tp and set(tp) == set(jp)
    width = cfg.vocab * max(1, cfg.n_codebooks)
    head = tp["lm_head"]
    assert (head["w"] if "w" in head else head["scale"]).shape[-1] == width


def test_forward_matches_jax(pair):
    cfg, jm, jp, tm, tp, mode = pair
    emb, pos = _inputs(cfg)
    want = jax.jit(lambda p, b: jm.forward(p, b, J[mode]))(jp, _batch(emb, pos, 0, S, False))
    got = tm.forward(tp, _batch(emb, pos, 0, S, True), T[mode])
    if cfg.n_codebooks:
        assert got.shape == (B, S, cfg.n_codebooks, cfg.vocab)
    _close(got, want)


def test_prefill_then_decode_steps_match_jax(pair):
    """prefill on S embeddings, then DECODES decode steps fed the next
    embeddings (musicgen with ``pos_offset``, qwen2-vl with its positions):
    logits and the caches' K/V and positions, step by step."""
    cfg, jm, jp, tm, tp, mode = pair
    emb, pos = _inputs(cfg)
    max_len = S + DECODES + 1
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, J[mode], max_len=max_len))(
        jp, _batch(emb, pos, 0, S, False))
    tl, tc = tm.prefill(tp, _batch(emb, pos, 0, S, True), T[mode], max_len=max_len)
    _close(tl, jl)
    jdec = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, J[mode]))
    for i in range(S, S + DECODES):
        off = i if cfg.rope_fraction == 0.0 else None
        jl, jc = jdec(jp, _batch(emb, pos, i, i + 1, False, off), jc)
        tl, tc = tm.decode_step(tp, _batch(emb, pos, i, i + 1, True, off), tc, T[mode])
        if cfg.n_codebooks:
            assert tl.shape == (B, 1, cfg.n_codebooks, cfg.vocab)
        _close(tl, jl)
    for name in ("k", "v", "pos"):
        _close(tc["layers"][name], jc["layers"][name])


def test_prefill_and_decode_agree_with_the_full_forward(pair):
    """decode_step(prefill(x)) gives the full forward's logits at the same
    position, on embeddings (the reference's consistency check, which its
    token-input form skips for these configs)."""
    cfg, _, _, tm, tp, mode = pair
    emb, pos = _inputs(cfg, seed=2)
    full = tm.forward(tp, _batch(emb, pos, 0, S + 1, True), T[mode])
    lp, cache = tm.prefill(tp, _batch(emb, pos, 0, S, True), T[mode], max_len=S + 4)
    off = S if cfg.rope_fraction == 0.0 else None
    ld, _ = tm.decode_step(tp, _batch(emb, pos, S, S + 1, True, off), cache, T[mode])
    scale = float(full.abs().max())
    assert float((full[:, S - 1] - lp[:, 0]).abs().max()) / scale < 1e-4
    assert float((full[:, S] - ld[:, 0]).abs().max()) / scale < 1e-4


def test_mrope_without_positions_raises_a_value_error():
    """forward without positions, and prefill_extend (which passes none, as
    the reference's does), raise ValueError naming the positions."""
    cfg, tm = registry.load("qwen2-vl-2b", smoke=True)
    tp = tm.init_params(0, T["train"], device="cpu")
    emb = torch.randn(B, 4, cfg.d_model)
    with pytest.raises(ValueError, match="positions"):
        tm.forward(tp, {"inputs_embeds": emb}, T["train"])
    cache = tm.init_cache(B, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        tm.prefill_extend(tp, {"inputs_embeds": emb}, cache, T["train"])
