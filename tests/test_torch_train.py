"""The port's training side against the JAX package: the optimizer, the
gradient compression, the data, the train step, checkpoints, the train CLI
and the QAT example.

* Exact: the int8 gradient codes, scales and residuals; the synthetic
  corpus's batches for every seed, step and host; checkpoints read across
  the two packages (f32 and integer leaves) and a resumed run's losses and
  params against the uninterrupted run's.
* AdamW over 5 steps: params, moments, gnorm and lr within rtol 1e-6 (pow,
  sqrt and the norm's sum may round in another order); the reference's
  decay mask is pinned (a stacked norm scale is decayed, the final norm's
  is not).
* 3 train steps of smoke phi4-mini from the reference's params, with and
  without QAT, 1 and 2 microbatches: losses within rtol 1e-4 of the
  reference's (the matmuls sum in another order, and each step's params
  carry that into the next loss).
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.data import pipeline as jdata
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.optim import grad_compression as jgc
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch import tree as T
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.data import pipeline as tdata
from repro_torch.examples import qat_train_then_serve
from repro_torch.launch import train as tcli
from repro_torch.models import registry
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compression as tgc
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop

jax.config.update("jax_platform_name", "cpu")

ARCH = "phi4-mini-3.8b"
J_CFG = {qat: JCascadeConfig(mode="train", qat=qat, compute_dtype=jnp.float32)
         for qat in (False, True)}
T_CFG = {qat: CascadeConfig(mode="train", qat=qat, compute_dtype=torch.float32)
         for qat in (False, True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _flat_np(tree):
    return [np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
            for leaf in T.leaves(tree)]


@pytest.fixture(scope="module")
def phi4():
    cfg, jm = jregistry.load(ARCH, smoke=True)
    jp = jax.jit(lambda k: jm.init_params(k, J_CFG[True]))(jax.random.PRNGKey(0))
    _, tm = registry.load(ARCH, smoke=True)
    return cfg, jm, jp, tm


def _grads_like(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                                              * 0.3), jp)


# ---------------------------------------------------------------------------
# optimizer, compression, data
# ---------------------------------------------------------------------------

def test_adamw_five_steps_equal_jax_and_the_decay_mask_is_the_references(phi4):
    _, _, jp, _ = phi4
    jopt = jadamw.AdamW(lr=1e-2, warmup_steps=2, decay_steps=5, grad_clip=0.5)
    topt = tadamw.AdamW(lr=1e-2, warmup_steps=2, decay_steps=5, grad_clip=0.5)
    tp = _carry(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(5):
        g = _grads_like(jp, i)
        jp, js, jm = jax.jit(jopt.update)(g, js, jp)
        tp, ts, tm = topt.update(_carry(g), ts, tp)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for name, a, b in (("params", tp, jp), ("mu", ts.mu, js.mu), ("nu", ts.nu, js.nu)):
            for x, y in zip(_flat_np(a), _flat_np(_carry(b))):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7, err_msg=name)
    assert int(ts.step) == int(js.step) == 5
    # the mask: zero gradients leave only the decay term, which reaches the
    # stacked (L, d) norm scales and biases but not the (d,) final norm
    before = {k: v.clone() for k, v in (("ln1", tp["layers"]["ln1"]["scale"]),
                                        ("final", tp["final_norm"]["scale"]))}
    zeros = T.tree_map(torch.zeros_like, tp)
    tp, ts, _ = topt.update(zeros, tadamw.AdamWState(ts.step, T.tree_map(torch.zeros_like, ts.mu),
                                                     T.tree_map(torch.zeros_like, ts.nu)), tp)
    assert tp["layers"]["ln1"]["scale"].dim() == 2
    assert not torch.equal(tp["layers"]["ln1"]["scale"], before["ln1"])
    assert torch.equal(tp["final_norm"]["scale"], before["final"])


def test_adamw_piecewise_update_of_large_leaves_keeps_every_bit(phi4, monkeypatch):
    """A leaf past ``PIECE`` elements is updated in row blocks (layers of a
    stacked leaf): the same params and moments, bit for bit, as one pass."""
    _, _, jp, _ = phi4
    opt = tadamw.AdamW(lr=1e-2, warmup_steps=1)
    runs = []
    for piece in (tadamw.PIECE, 1000):
        monkeypatch.setattr(tadamw, "PIECE", piece)
        tp = _carry(jp)
        st = opt.init(tp)
        for i in range(2):
            tp, st, _ = opt.update(_carry(_grads_like(jp, i)), st, tp)
        runs.append(T.leaves((tp, st)))
    assert max(p.numel() for p in T.leaves(_carry(jp))) > 1000
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_grad_compression_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((64, 33)) * 0.01).astype(np.float32)
    r = (rng.standard_normal((64, 33)) * 1e-4).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]                    # codes at exact halves
    jq, js, jr = jgc.compress(jnp.asarray(g), jnp.asarray(r))
    tq, ts, tr = tgc.compress(_t(g), _t(r))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(tr.numpy().view(np.uint32), np.asarray(jr).view(np.uint32))
    np.testing.assert_array_equal(tgc.decompress(tq, ts).numpy(),
                                  np.asarray(jgc.decompress(jq, js)))
    res = tgc.init_residuals({"a": _t(g), "b": [_t(r)]})
    assert res["a"].dtype == torch.float32 and not res["b"][0].any()


@pytest.mark.parametrize("seed,hosts", [(0, 1), (3, 2), (7, 4)])
def test_synthetic_corpus_batches_equal_jax(seed, hosts):
    for host in range(hosts):
        kw = dict(vocab=97, seq_len=13, global_batch=8, seed=seed, host_id=host, n_hosts=hosts)
        jc, tc = jdata.SyntheticCorpus(jdata.DataConfig(**kw)), \
            tdata.SyntheticCorpus(tdata.DataConfig(**kw))
        for step in (0, 1, 5, 1000):
            jb, tb = jc.batch_at(step), tc.batch_at(step)
            assert set(jb) == set(tb) == {"tokens", "labels"}
            for k in jb:
                assert tb[k].dtype == jb[k].dtype and tb[k].shape == (8 // hosts, 13)
                np.testing.assert_array_equal(tb[k], jb[k])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qat,micro", [(False, 1), (True, 1), (True, 2)])
def test_three_train_steps_from_the_references_params_equal_jax(phi4, qat, micro):
    cfg, jm, jp, tm = phi4
    jopt = jadamw.AdamW(lr=3e-3, warmup_steps=2, decay_steps=3)
    topt = tadamw.AdamW(lr=3e-3, warmup_steps=2, decay_steps=3)
    data = tdata.SyntheticCorpus(tdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    jstate = jloop.TrainState(jp, jopt.init(jp), jnp.int32(0))
    tp = _carry(jp)
    for leaf in T.leaves(tp):
        leaf.requires_grad_(True)
    tstate = tloop.TrainState(tp, topt.init(tp), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jloop.make_train_step(jm, J_CFG[qat], jopt, microbatches=micro, remat=False))
    tstep = tloop.make_train_step(tm, T_CFG[qat], topt, microbatches=micro, remat=False)
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, batch)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
    assert int(tstate.step) == 3 and int(tstate.opt.step) == 3
    for x, y in zip(_flat_np(tstate.params), _flat_np(_carry(jstate.params))):
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5)


def test_cross_entropy_takes_the_codebook_layout():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 4, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 3, 4)).astype(np.int32)
    np.testing.assert_allclose(float(tloop.cross_entropy(_t(logits), _t(labels))),
                               float(jloop.cross_entropy(jnp.asarray(logits),
                                                         jnp.asarray(labels))), rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_state(phi4, seed=0):
    cfg, _, _, tm = phi4
    opt = tadamw.AdamW(lr=3e-3, warmup_steps=2, decay_steps=6)
    return opt, tloop.init_state(tm, T_CFG[True], opt, seed=seed, device="cpu")


def test_checkpoint_round_trip_latest_step_async_and_atomic(phi4, tmp_path):
    _, state = _port_state(phi4)
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    t = tckpt.save(state, d, 3, extra={"data_step": 3}, async_=True)
    t.join()
    os.makedirs(os.path.join(d, "step_9.tmp"))          # an unfinished save: not a step
    tckpt.save(state, d, 5)
    assert tckpt.latest_step(d) == 5 and sorted(os.listdir(d)) == ["step_3", "step_5",
                                                                    "step_9.tmp"]
    manifest = json.load(open(os.path.join(d, "step_3", "manifest.json")))
    names = [e["name"] for e in manifest["leaves"]]
    assert names[0] == ".params/embed/table" and names[-1] == ".step"
    assert ".opt/.step" in names and ".opt/.mu/layers/ln1/scale" in names
    _, other = _port_state(phi4, seed=1)
    back, extra = tckpt.restore(other, d, step=3)
    assert extra == {"data_step": 3}
    for x, y in zip(T.leaves(back), T.leaves(state)):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
    assert all(p.requires_grad for p in T.leaves(back.params))
    # bf16 leaves go to disk as their uint16 bits
    bf = {"w": torch.randn(5, 3).to(torch.bfloat16)}
    tckpt.save(bf, d, 7)
    e = json.load(open(os.path.join(d, "step_7", "manifest.json")))["leaves"][0]
    assert e["dtype"] == "bfloat16" and np.load(os.path.join(d, "step_7", e["file"])).dtype == \
        np.uint16
    got, _ = tckpt.restore({"w": torch.zeros(5, 3, dtype=torch.bfloat16)}, d)
    assert torch.equal(got["w"], bf["w"])
    with pytest.raises(FileNotFoundError):
        tckpt.restore(state, str(tmp_path / "none"))


def test_checkpoints_cross_load_between_the_packages(phi4, tmp_path):
    """A JAX-written f32 TrainState restores into the port's, and the port's
    into the reference's, leaf for leaf."""
    cfg, jm, jp, tm = phi4
    jopt = jadamw.AdamW()
    jopt_state = jopt.init(jp)
    jopt_state = jopt_state._replace(mu=_grads_like(jp, 1), step=jnp.int32(4))
    jstate = jloop.TrainState(jp, jopt_state, jnp.int32(4))
    jckpt.save(jstate, str(tmp_path / "jax"), 4, extra={"data_step": 4})
    _, like = _port_state(phi4, seed=2)
    got, extra = tckpt.restore(like, str(tmp_path / "jax"))
    assert extra == {"data_step": 4}
    want = jax.tree.leaves(jstate)
    assert len(want) == len(T.leaves(got))
    for x, y in zip(_flat_np(got), want):
        np.testing.assert_array_equal(x, np.asarray(y))
    # and back: the port's state read by the reference
    tckpt.save(got, str(tmp_path / "torch"), 4, extra={"data_step": 4})
    jlike = jloop.TrainState(jax.tree.map(jnp.zeros_like, jp), jopt.init(jp), jnp.int32(0))
    jback, jextra = jckpt.restore(jlike, str(tmp_path / "torch"))
    assert jextra == {"data_step": 4}
    for x, y in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resume_from_a_checkpoint_is_bit_identical(phi4, tmp_path):
    cfg, _, _, tm = phi4
    data = tdata.SyntheticCorpus(tdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    opt, state = _port_state(phi4)
    step = tloop.make_train_step(tm, T_CFG[True], opt, remat=False)
    losses = []
    for i in range(6):
        state, m = step(state, data.batch_at(i))
        losses.append(m["loss"])
        if i == 2:
            tckpt.save(state, str(tmp_path), 3, extra={"data_step": 3}, async_=True).join()
    _, fresh = _port_state(phi4, seed=5)
    resumed, extra = tckpt.restore(fresh, str(tmp_path))
    for i in range(extra["data_step"], 6):
        resumed, m = step(resumed, data.batch_at(i))
        assert torch.equal(m["loss"], losses[i])
    for x, y in zip(T.leaves(resumed), T.leaves(state)):
        assert torch.equal(x.detach(), y.detach())


# ---------------------------------------------------------------------------
# the train CLI and the QAT example
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_the_cpu_and_refuses_without_a_card(capsys, tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--qat", "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1"]
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert out.count("step ") >= 3 and "final loss" in out and "device=cpu" in out
    assert tckpt.latest_step(ck) == 2
    assert tcli.main(args[:-6] + ["--steps", "4", "--ckpt-dir", ck, "--resume"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--arch", ARCH, "--smoke", "--steps", "1"]) == 2
    assert "GPU" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tcli.main(["--smoke", "--device", "cpu", "--mesh", "production"])


@pytest.fixture
def one_thread():
    """One intra-op thread: the example's many small ops slow down by tens of
    times when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_qat_example_trains_converts_and_serves_on_the_cpu(tmp_path, capsys, one_thread):
    res = qat_train_then_serve.main(["--device", "cpu", "--steps", "12",
                                     "--ckpt-dir", str(tmp_path)])
    assert res["last_loss"] < res["first_loss"]
    assert np.isfinite(res["ce_dense"]) and np.isfinite(res["ce_fp4"])
    assert all(r.done and len(r.tokens_out) == 8 for r in res["requests"])
    assert sorted(os.listdir(tmp_path)) == ["step_10"]
    assert "val CE: dense" in capsys.readouterr().out
