"""The port's quickstart and fault-tolerance demo against the JAX package, on
the inputs the reference examples draw (``jax.random.PRNGKey(0..3)``,
``np.random.default_rng(0)``), carried across with
``convert.params_from_numpy``; both sides at f32 on the CPU.

The reference examples are not run whole (the quickstart's interpret-mode
Pallas call alone takes most of its 35 s): their values are computed here
through the JAX functions they call.

* Quickstart: the dense and FP4 byte counts equal; the FP4 path equals the
  dense forward of the round-tripped weights (<= 1e-6, the reference prints
  0); the FP4-vs-dense relative error within 1e-4 of JAX's; the FP4 matmul
  within 1e-5 of JAX's ``cascade_matmul_ref`` on the same codes; the
  oracle's max |sum| bit for bit.
* Demo: CREST's detections, false positives and repairs equal JAX's, the
  error after repair <= 1e-5; fail-in-place completes 9/9 with every stream
  equal to the JAX ``ReplicaSet`` run's and the same replicas healthy; the
  port's resumed training tail is bit-equal to its uninterrupted one, its
  six losses within rtol 1e-5 of JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import cascade as jcascade
from repro.core import crest as jcrest
from repro.core import quant as jquant
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.data import pipeline as jdata
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro.optim.adamw import AdamW as JAdamW
from repro.serve.elastic import ReplicaSet as JReplicaSet
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import loop as jloop
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.core.cascade import CascadeConfig
from repro_torch.data import pipeline as tdata
from repro_torch.examples import fault_tolerance_demo as demo
from repro_torch.examples import quickstart
from repro_torch.kernels import ops as tops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW

jax.config.update("jax_platform_name", "cpu")

J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_SERVE = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_TRAIN = CascadeConfig(mode="train", compute_dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _nbytes(tree):
    return sum(v.size * v.dtype.itemsize for v in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_ptq_and_forward_equal_jax():
    cfg, jm = jregistry.load(quickstart.ARCH, smoke=True)
    jp = jax.jit(lambda k: jm.init_params(k, J_TRAIN))(jax.random.PRNGKey(0))
    jfp4 = jcascade.tree_to_serve_fp4(jp, J_SERVE)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab)
    fwd = jax.jit(jm.forward, static_argnums=2)
    lf = fwd(jfp4, {"tokens": tokens}, J_SERVE)
    lr = fwd(jp, {"tokens": tokens}, J_TRAIN)
    j_rel = float(jnp.max(jnp.abs(lf - lr)) / jnp.max(jnp.abs(lr)))

    _, tm = registry.load(quickstart.ARCH, smoke=True)
    res = quickstart.ptq_and_forward(tm, _carry(jp), _t(tokens), T_TRAIN, fused=False)
    assert res["dense_bytes"] == _nbytes(jp)
    assert res["fp4_bytes"] == _nbytes(jfp4)
    assert res["exactness"] <= 1e-6 and res["finite"]
    assert abs(res["fp4_vs_dense"] - j_rel) <= 1e-4, (res["fp4_vs_dense"], j_rel)


def test_quickstart_matmul_and_oracle_equal_jax():
    w = jax.random.normal(jax.random.PRNGKey(2), (128, 64)) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 128))
    jpacked, jscales = jquant.quantize_weight(w, group_size=64)
    y_ref = jops.cascade_matmul_ref(x, jpacked, jscales)
    w4 = jquant.dequantize_weight(jpacked, jscales, jnp.float32)
    xs = jnp.max(jnp.abs(x)) / jquant.FP4_MAX
    x4 = jquant.fp4_decode(jquant.fp4_encode(x / xs))
    j_sum = float(jnp.max(jnp.abs(jquant.cascade_matmul_exact(
        x4, w4 / jnp.max(jnp.abs(w4)) * jquant.FP4_MAX))))

    tw, tx = _t(w), _t(x)
    packed, scales = tquant.quantize_weight(tw, group_size=64)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    y = tops.cascade_matmul(tx, packed, scales)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=1e-5)
    mm = quickstart.matmul_three_ways(tw, tx)
    assert mm["kernel_vs_ref"] == 0.0 and mm["finite"]
    assert mm["oracle_max_abs_sum"] == j_sum, (mm["oracle_max_abs_sum"], j_sum)


def test_quickstart_cli_runs_on_the_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "exactness" in out and "max |sum|" in out
    assert res["exactness"] <= 1e-6 and res["kernel_vs_ref"] == 0.0
    # --fused: the FP4 linears through the kernel wrappers' plain versions,
    # whose sums run per scale group (another order than the dense matmul's)
    fused = quickstart.main(["--device", "cpu", "--fused"])
    assert fused["exactness"] <= 1e-5 and fused["fused"]
    assert all(np.isfinite(fused[k]) for k in ("exactness", "fp4_vs_dense",
                                               "oracle_max_abs_sum"))
    assert fused["oracle_max_abs_sum"] == res["oracle_max_abs_sum"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        quickstart.main([])


def test_the_codec_by_column_blocks_keeps_every_bit(monkeypatch):
    """A matrix past ``quant.CODEC_BLOCK`` elements (llama3.1-405b's head)
    is quantized, decoded and multiplied by blocks of columns: the codes,
    scales and dense weights are those of one pass, the plain matmul within
    f32 rounding of it."""
    gen = torch.Generator().manual_seed(0)
    w, x, b = (torch.randn(s, generator=gen) for s in ((63, 50), (3, 64), (50,)))
    from repro_torch.kernels import cascade_matmul as tcm
    whole = [*tquant.quantize_weight(w)]
    whole += [tquant.dequantize_weight(*whole[:2], torch.float32),
              tcm.cascade_matmul_plain(x, *whole[:2], b)]
    monkeypatch.setattr(tquant, "CODEC_BLOCK", 64 * 7)
    assert len(tquant.column_blocks(64, 50)) == 8
    blocked = [*tquant.quantize_weight(w)]
    blocked += [tquant.dequantize_weight(*blocked[:2], torch.float32),
                tcm.cascade_matmul_plain(x, *blocked[:2], b)]
    for a, c in zip(whole[:3], blocked[:3]):
        assert torch.equal(a, c)
    np.testing.assert_allclose(blocked[3].numpy(), whole[3].numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fault-tolerance demo
# ---------------------------------------------------------------------------

def test_demo_crest_equals_jax():
    cfg = demo.CREST_CFG
    k, n = 64, 128
    w = jax.random.normal(jax.random.PRNGKey(0), (k, n)) * 0.2
    faults = jcrest.inject_column_faults(jax.random.PRNGKey(1), n, 5)
    xs = [jax.random.normal(jax.random.PRNGKey(100 + i), (16, k))
          for i in range(demo.CREST_STEPS)]
    x_final = jax.random.normal(jax.random.PRNGKey(999), (16, k))
    jcfg = jcrest.CrestConfig(n_spares=cfg.n_spares, threshold=cfg.threshold)
    step = jax.jit(lambda x, s, f: jcrest.crest_matmul(x, w, s, jcfg, f))
    state = jcrest.crest_init(n, jcfg)
    for i, x in enumerate(xs):
        _, state = step(x, state, faults.at[0].set(True) if i == demo.CREST_GLITCH_STEP
                        else faults)
    jstats = jcrest.coverage_stats(state, faults)

    res = demo.demo_crest(_t(w), _t(faults), [_t(x) for x in xs], _t(x_final))
    for key in ("injected", "detected", "false_positives", "repaired"):
        assert res[key] == int(jstats[key]), (key, res[key], jstats[key])
    assert (res["detected"], res["false_positives"], res["repaired"]) == (5, 0, 5)
    assert res["faulty_columns"] == np.flatnonzero(np.asarray(faults)).tolist()
    assert res["post_repair_max_err"] <= 1e-5


def test_demo_fail_in_place_streams_equal_the_jax_replica_set():
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jp = jax.jit(lambda k: jm.init_params(k, J_TRAIN))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32) for _ in range(9)]
    rs = JReplicaSet([JServeEngine(jm, jp, J_TRAIN, JServeConfig(max_batch=2, max_len=48))
                      for _ in range(3)])
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        rs.submit(r)
    rs.step()
    rs.kill_replica(0)
    rs.drain(max_steps=300)
    final = {r.uid: r for r in reqs}
    final.update({r.uid: r for r in rs.requeued})
    j_streams = {uid: [int(t) for t in r.tokens_out] for uid, r in sorted(final.items())}

    _, tm = registry.load("codeqwen1.5-7b", smoke=True)
    res = demo.demo_fail_in_place(tm, _carry(jp), T_TRAIN, prompts, "cpu")
    assert res["completed"] == res["requests"] == 9
    assert res["rebuilt"] >= 1
    assert res["streams"] == j_streams
    assert res["healthy"] == [i for i, h in enumerate(rs.health) if h.alive] == [1, 2]


def test_demo_checkpoint_restart_is_bit_identical_and_its_losses_equal_jax():
    cfg, jm = jregistry.load("phi4-mini-3.8b", smoke=True)
    jopt = JAdamW(lr=1e-3, warmup_steps=2, decay_steps=10)
    jdc = jdata.SyntheticCorpus(jdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    jstate = jloop.init_state(jm, J_TRAIN, jopt)
    params0 = _carry(jstate.params)
    step = jax.jit(jloop.make_train_step(jm, J_TRAIN, jopt, remat=False))
    j_losses = []
    for i in range(6):
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, jdc.batch_at(i)))
        j_losses.append(float(m["loss"]))

    _, tm = registry.load("phi4-mini-3.8b", smoke=True)
    res = demo.demo_checkpoint_restart(
        tm, T_TRAIN, params0,
        tdata.SyntheticCorpus(tdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)),
        AdamW(lr=1e-3, warmup_steps=2, decay_steps=10))
    assert res["tail_bit_equal"] and res["max_rel_diff"] == 0.0
    assert res["resumed_tail"] == res["losses"][3:]
    np.testing.assert_allclose(res["losses"], j_losses, rtol=1e-5)


def test_demo_cli_runs_on_the_cpu(capsys):
    res = demo.main(["--device", "cpu", "--fused"])
    out = capsys.readouterr().out
    assert "bit-identical resume confirmed" in out
    assert (res["crest"]["detected"], res["crest"]["false_positives"],
            res["crest"]["repaired"]) == (5, 0, 5)
    assert res["fail_in_place"]["completed"] == 9
    assert res["fail_in_place"]["effective_mode"] == "batched-greedy-fused"
    assert res["checkpoint_restart"]["tail_bit_equal"]
