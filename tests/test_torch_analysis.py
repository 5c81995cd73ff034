"""The port's serving-step checks (``repro_torch.analysis``): each check
holds against a small step written to break it, and the shipped engine and
tree pass (the counterpart of ``tests/test_audit.py``).

* census and contract: a closure that reads the host (``.item()``,
  ``int(t)``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool(t)``, a
  tensor made from host data, a data-shaped op), reallocates a cache leaf,
  makes an f64 tensor, or dequantizes a packed leaf on the kernel route (the
  audit's one allowlist entry, MLA's ``wkv_b``, covers no other leaf);
* retrace: a plan cache that grows, or a library built, on the second run;
* lint: each rule trips and honours its allowlist marker; ``time-read``
  gives the reference lint's findings on the same sources; the shipped tree
  lints clean but for its allowlisted sites;
* end to end: ``audit_engine`` over the codeqwen smoke engine (speculative,
  sampled, FP4; dense and paged caches) has no gating finding, the slot-wise
  engine gives an info finding, a downgrade gates unless the audit expects
  it, and the audit CLI over one family exits 0.
"""
import functools
import os
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as jlint
from repro_torch.analysis import audit, census, contract, lint, retrace
from repro_torch.analysis.findings import Finding, gating
from repro_torch.core import quant
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels import build
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _audit(fn, *args, name="decode", **kw):
    return contract.audit_step(name, fn, args, contract.ServingContract(), **kw)


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("read", ["item", "int", "float", "bool", "tolist", "cpu", "numpy"])
def test_census_sees_each_host_read_on_the_cpu(read):
    reads = {"item": lambda t: t.sum().item(), "int": lambda t: int(t[0]),
             "float": lambda t: float(t[1]), "bool": lambda t: bool(t[0] > 0),
             "tolist": lambda t: t.tolist(), "cpu": lambda t: t.cpu(),
             "numpy": lambda t: t.numpy()}

    def step(t):
        reads[read](t)
        return t * 2
    x = torch.arange(4.0)
    _, c = census.record(step, (x,))
    assert len(c.host_reads) == 1, c.host_reads
    _, fs = _audit(step, x, takes_params=False)
    assert [f.check for f in gating(fs)] == ["host-read"], fs
    # the same arithmetic without the read is clean
    _, fs = _audit(lambda t: t * 2, x, takes_params=False)
    assert fs == []


@pytest.mark.parametrize("case", ["host_data", "nonzero", "bool_index", "device_copy"])
def test_census_sees_host_data_and_data_shaped_ops(case):
    steps = {"host_data": lambda t: t + torch.tensor([1.0, 2.0, 3.0, 4.0]),
             "nonzero": lambda t: torch.nonzero(t).sum() + t,
             "bool_index": lambda t: t[t > 1].sum() + t,
             "device_copy": lambda t: t.to("meta").sum()}
    _, c = census.record(steps[case], (torch.arange(4.0),))
    assert len(c.host_reads + c.host_transfers + c.data_shaped) == 1, c
    _, fs = _audit(steps[case], torch.arange(4.0), takes_params=False)
    assert any(f.check == "host-read" and f.level == "error" for f in fs), fs


def test_a_host_read_names_its_line_in_the_port():
    """The finding points at the port's source line that read the host: a
    chunk's ``n_valid`` handed over as a tensor is read by ``int()``."""
    from repro_torch.models import ssm

    def step(x, n_valid):
        return ssm._conv_extend(x, torch.zeros((1, 3, 8)), torch.ones((4, 8)), torch.zeros(8),
                                n_valid=n_valid)
    x = torch.ones((1, 5, 8))
    _, fs = _audit(step, x, torch.tensor(3), takes_params=False)
    assert [f.where.split(":")[1] for f in gating(fs)] == ["repro_torch/models/ssm.py"], fs
    _, fs = _audit(step, x, 3, takes_params=False)         # the served path: a Python int
    assert fs == []


# ---------------------------------------------------------------------------
# the cache updated in place
# ---------------------------------------------------------------------------

def _cache():
    return {"layers": {"k": torch.zeros((2, 4, 64)), "pos": torch.zeros((2,), dtype=torch.int32)}}


def test_a_reallocated_cache_leaf_trips_and_an_in_place_update_passes():
    def in_place(cache, x):
        cache["layers"]["k"][:, 0] += x
        cache["layers"]["pos"] += 1
        return x.sum(), cache

    def realloc(cache, x):
        cache["layers"]["k"] = torch.cat([x[:, None], cache["layers"]["k"][:, 1:]], dim=1)
        return x.sum(), cache

    x = torch.ones((2, 64))
    st, fs = _audit(in_place, _cache(), x, takes_params=False, cache_arg=0, cache_out=1)
    assert fs == [] and st["cache_leaves_in_place"] == st["cache_major_leaves"] == 1
    st, fs = _audit(realloc, _cache(), x, takes_params=False, cache_arg=0, cache_out=1)
    assert [f.check for f in fs] == ["in-place-cache"] and st["cache_leaves_in_place"] == 0
    # a new cache returned beside the untouched input is caught too
    fresh = lambda cache, x: (x.sum(), {"layers": {k: v.clone() for k, v in
                                                   cache["layers"].items()}})
    _, fs = _audit(fresh, _cache(), x, takes_params=False, cache_arg=0, cache_out=1)
    assert [f.check for f in fs] == ["in-place-cache"]
    # best-effort closures and sub-floor leaves do not gate
    _, fs = _audit(realloc, _cache(), x, name="rewind", takes_params=False, cache_arg=0,
                   cache_out=1)
    assert fs == []

    def pos_only(cache, x):
        cache["layers"]["pos"] = cache["layers"]["pos"] + 1      # 8 bytes: advisory
        return x.sum(), cache
    _, fs = _audit(pos_only, _cache(), x, takes_params=False, cache_arg=0, cache_out=1)
    assert fs == []


# ---------------------------------------------------------------------------
# dtypes and packed weights
# ---------------------------------------------------------------------------

def test_an_f64_tensor_in_a_step_trips():
    _, fs = _audit(lambda t: (t.double() * 2).float(), torch.ones(4), takes_params=False)
    assert [f.check for f in gating(fs)] == ["dtype"] and "2 f64 output(s)" in fs[0].detail
    _, fs = _audit(lambda t: (t * 2).float(), torch.ones(4), takes_params=False)
    assert fs == []


def _packed_params(k=64, n=32):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((k, n), generator=gen)
    codes, scale = quant.quantize_weight(w)
    return {"lin": {"codes": codes, "scale": scale}, "norm": torch.ones(k)}


def test_a_densified_weight_gates_on_the_kernel_route_and_is_info_on_the_plain():
    params = _packed_params()

    def dequantizing(p, x):
        lin = p["lin"]
        return x @ quant.dequantize_weight(lin["codes"], lin["scale"], torch.float32)

    def packed_route(p, x):      # what the kernel route does: no dense weight is made
        return x @ torch.ones((64, 32))
    x = torch.ones((3, 64))
    _, fs = _audit(dequantizing, params, x, params=params, kernel_route=True)
    assert [f.check for f in gating(fs)] == ["densified-weight"], fs
    _, fs = _audit(dequantizing, params, x, params=params, kernel_route=False)
    assert gating(fs) == [] and [f.level for f in fs] == ["info"]
    _, fs = _audit(packed_route, params, x, params=params, kernel_route=True)
    assert fs == []


def test_the_moe_allowlist_entry_covers_wkv_b_alone():
    """MLA's ``wkv_b`` densified on the kernel route is the known limitation;
    an expert stack densified in the same moe closure still gates."""
    gen = torch.Generator().manual_seed(0)
    wkv_b = dict(zip(("codes", "scale"), quant.quantize_weight(torch.randn((32, 128),
                                                                             generator=gen))))
    experts = [quant.quantize_weight(torch.randn((64, 32), generator=gen)) for _ in range(4)]
    wg = {"codes": torch.stack([c for c, _ in experts]),
          "scale": torch.stack([s for _, s in experts])}
    params = {"layers": {"attn": {"wkv_b": wkv_b}, "moe": {"wg": wg}}}

    def mla_only(p, x):
        a = p["layers"]["attn"]["wkv_b"]
        return x @ quant.dequantize_weight(a["codes"], a["scale"], torch.float32)

    def mla_and_experts(p, x):
        e = p["layers"]["moe"]["wg"]
        stack = torch.stack([quant.dequantize_weight(e["codes"][i], e["scale"][i],
                                                     torch.float32) for i in range(4)])
        return mla_only(p, x), stack.sum()

    x = torch.ones((3, 32))
    _, fs = _audit(mla_only, params, x, params=params, kernel_route=True)
    assert [f.where for f in fs] == ["decode:layers/attn/wkv_b"]
    audit._mark_known("moe", "kernel", fs)
    assert gating(fs) == [] and fs[0].allowlisted and "known limitation" in fs[0].detail
    _, fs = _audit(mla_and_experts, params, x, params=params, kernel_route=True)
    audit._mark_known("moe", "kernel", fs)
    assert [f.where for f in gating(fs)] == ["decode:layers/moe/wg"], fs
    # the entry is the moe family's on the kernel route alone
    _, fs = _audit(mla_only, params, x, params=params, kernel_route=True)
    audit._mark_known("transformer", "kernel", fs)
    assert [f.where for f in gating(fs)] == ["decode:layers/attn/wkv_b"]


def test_the_packed_weight_contract_trips_on_a_densified_tree():
    c = contract.ServingContract(require_packed_weights=True)
    dense = {"lin": {"w": torch.ones((64, 32))}}
    packed = _packed_params()
    step = lambda p, x: x * 2
    _, fs = contract.audit_step("decode", step, (dense, torch.ones(2)), c, params=dense)
    assert any("densified" in f.detail for f in gating(fs)), fs
    st, fs = contract.audit_step("decode", step, (packed, torch.ones(2)), c, params=packed)
    assert fs == [] and st["packed_params"] == 1
    # a param-less closure (write, rewind) is exempt
    _, fs = contract.audit_step("write", step, (dense, torch.ones(2)), c, takes_params=False)
    assert fs == []


# ---------------------------------------------------------------------------
# retrace
# ---------------------------------------------------------------------------

def test_retrace_flags_a_plan_cache_that_grows_and_a_rebuild(monkeypatch):
    mod = types.ModuleType("fake_kernel")

    @functools.lru_cache(maxsize=None)
    def plan(n):
        return n * 2
    plan.__module__ = mod.__name__
    mod.plan = plan
    calls = []

    def stable():
        plan(8)

    def drifting():
        calls.append(1)
        plan(8 + len(calls))     # a key that drifts per run

    fs = retrace.retrace_findings(stable, kernel_route=True, modules=[mod])
    assert fs == []
    fs = retrace.retrace_findings(drifting, kernel_route=True, modules=[mod])
    assert [(f.check, f.where, f.level) for f in fs] == [("retrace", "fake_kernel.plan",
                                                          "error")]
    # a library built again on the second run
    runs = []

    def rebuilding():
        runs.append(1)
        if len(runs) == 2:
            monkeypatch.setitem(build.COUNTS, "compiles", build.COUNTS["compiles"] + 1)
    fs = retrace.retrace_findings(rebuilding, kernel_route=True, modules=[mod])
    assert [f.where for f in gating(fs)] == ["build.compiles"]
    # on the plain route the guard says it verified nothing
    fs = retrace.retrace_findings(stable, kernel_route=False, modules=[mod])
    assert [f.level for f in fs] == ["info"] and "verified nothing" in fs[0].detail


def test_retrace_reads_every_lru_cache_of_the_kernel_modules():
    names = set(retrace.cache_sizes())
    assert {"cascade_matmul._library", "cascade_matmul._grouped_library",
            "cascade_matmul.grouped_occupancy", "decode_attention._sm_count",
            "decode_attention._library", "flash_attention._library",
            "flash_attention._sm_count", "norm._library", "ssd_scan._launcher",
            "fake_quant._library", "fake_quant.plan", "cascade_exact._library"} <= names


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

TIME_SOURCES = [
    "import time\n\ndef f():\n    return time.monotonic()\n",
    "from time import perf_counter\nx = perf_counter()\n",
    "import os, time\nt0 = time.time()\nt1 = time.perf_counter_ns()\n",
    "def f(clock):\n    return clock.now()\n",
]


@pytest.mark.parametrize("src", TIME_SOURCES)
def test_lint_time_read_gives_the_reference_findings(src):
    for sub in ("serve/router.py", "serve/traffic.py", "core/cascade.py"):
        got = [(f.check, f.where.rsplit(":", 1)[1])
               for f in lint.lint_source(src, f"src/repro_torch/{sub}")]
        want = [(f.check, f.where.rsplit(":", 1)[1])
                for f in jlint.lint_source(src, f"src/repro/{sub}")]
        assert got == want, (sub, got, want)


def test_lint_host_sync_in_step_code():
    src = ("import torch\n"
           "class LM:\n"
           "    def decode_step(self, params, batch, cache, ccfg):\n"
           "        n = int(cache['pos'].max().item())\n"
           "        x = batch['tokens'].cpu().numpy()\n"
           "        torch.cuda.synchronize()\n"
           "        return batch['tokens'].tolist(), cache\n"
           "    def report(self, t):\n"
           "        return t.item()\n")
    fs = lint.lint_source(src, "src/repro_torch/models/transformer.py")
    assert sorted(int(f.where.rsplit(":", 1)[1]) for f in fs
                  if f.check == "host-sync-in-step") == [4, 5, 5, 6, 7], fs
    # outside models/ and kernels/ops.py the same methods are not step code
    assert lint.lint_source(src, "src/repro_torch/serve/engine.py") == []
    ops_src = "def norm(x):\n    return x.cpu()\n"
    assert [f.check for f in lint.lint_source(ops_src, "src/repro_torch/kernels/ops.py")] \
        == ["host-sync-in-step"]


def test_lint_torch_global_state_and_its_allowlist_marker():
    src = ("import torch\n"
           "torch.set_float32_matmul_precision('high')\n"
           "torch.backends.cuda.matmul.allow_tf32 = True\n"
           "torch.use_deterministic_algorithms(True)\n")
    fs = lint.lint_source(src, "src/repro_torch/core/cascade.py")
    assert [f.check for f in gating(fs)] == ["torch-global-state"] * 3, fs
    src2 = ("import torch\n"
            "# lint: allow[torch-global-state] — designated site\n"
            "torch.set_default_dtype(torch.float64)\n")
    fs2 = lint.lint_source(src2, "src/repro_torch/core/cascade.py")
    assert fs2 and all(f.allowlisted for f in fs2) and gating(fs2) == []


def test_lint_kernel_plain_pair():
    bad = ("def norm(x):\n"
           "    if x.is_cuda:\n"
           "        return _norm.norm_cuda(x)\n"
           "    return x\n")
    fs = lint.lint_source(bad, "src/repro_torch/kernels/ops.py")
    assert [f.check for f in fs] == ["kernel-plain-pair"], fs
    good = ("def norm(x):\n"
            "    if x.is_cuda:\n"
            "        return _kernel_call(lambda t: _norm.norm_cuda(t),\n"
            "                            lambda t: _norm.norm_plain(t), x)\n"
            "    return _norm.norm_plain(x)\n"
            "def fake_quant_fp4(w):\n"
            "    if w.is_cuda:\n"
            "        return _fq.fake_quant_fp4_cuda(w)\n"
            "    return _quant.fake_quant_fp4(w)\n")
    assert lint.lint_source(good, "src/repro_torch/kernels/ops.py") == []
    # the rule is scoped to the wrappers
    assert lint.lint_source(bad, "src/repro_torch/kernels/norm.py") == []


def test_shipped_tree_lints_clean_but_for_allowlisted_sites():
    fs = lint.lint_paths(["src/repro_torch"], base=REPO)
    assert gating(fs) == [], [f.to_dict() for f in gating(fs)]
    allowed = {f.where.rsplit(":", 1)[0] for f in fs if f.allowlisted}
    assert allowed == {"src/repro_torch/core/crest.py", "src/repro_torch/analysis/census.py"}
    assert lint.main(["src/repro_torch"]) == 0


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["dense", "paged"])
def spec_engine(request):
    """The codeqwen smoke engine with every closure live: FP4 params,
    sampling and speculation; dense or paged cache. A short trace ran."""
    cfg, model = registry.load("codeqwen1.5-7b", smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
    params = model.init_params(0, ccfg, device="cpu")
    scfg = ServeConfig(max_batch=2, max_len=48, temperature=0.7, draft_len=2, prefill_chunk=8,
                       fused=True, prefix_cache=request.param == "paged", page_size=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(model, params, ccfg, scfg, device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate([9, 4, 13]):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                           max_new_tokens=5))
    eng.run_until_drained()
    return request.param, eng


def test_audit_engine_shipped_codeqwen_is_clean(spec_engine):
    mode, eng = spec_engine
    cache_before = [t.clone() for t in eng.cache["layers"].values()]
    gen_before = eng._gen.get_state()
    res = contract.audit_engine(eng)
    assert gating(res["findings"]) == [], [f.to_dict() for f in gating(res["findings"])]
    names = set(res["closures"])
    paged = {"copy_page", "reset_pos"} if mode == "paged" else {"write"}
    assert names == {"decode", "extend", "verify", "rewind", "spec_sample", "sample",
                     "pick"} | paged
    assert res["contract"]["require_packed_weights"] is True
    for name in ("decode", "extend", "verify", "spec_sample", "sample"):
        st = res["closures"][name]
        assert st["packed_params"] > 0 and st["host_reads"] == 0, (name, st)
        assert st["cache_leaves_in_place"] == st["cache_major_leaves"] > 0, (name, st)
    # the plain route dequantizes by design: info, never silence
    assert any(f.check == "densified-weight" and f.level == "info" for f in res["findings"])
    assert any(f.check == "collective-budget" and f.level == "info" for f in res["findings"])
    # the audit ran on a copy: the engine's cache and generator are as they were
    assert all(torch.equal(a, b) for a, b in zip(cache_before, eng.cache["layers"].values()))
    assert torch.equal(gen_before, eng._gen.get_state())


def test_audit_engine_slotwise_is_info_not_silent():
    class Slotwise:
        batched = False
    res = contract.audit_engine(Slotwise(), contract.ServingContract())
    assert res["closures"] == {}
    assert res["findings"] and res["findings"][0].level == "info"
    assert gating(res["findings"]) == []


def test_finding_roundtrip_and_gating():
    f = Finding("in-place-cache", "decode", "reallocated", level="error")
    assert Finding.from_dict(f.to_dict()) == f
    a = Finding("densified-weight", "decode", "known", level="error", allowlisted=True)
    i = Finding("audit", "engine", "fyi", level="info")
    assert gating([f, a, i]) == [f]


def test_a_downgrade_is_info_where_expected_and_gates_elsewhere(monkeypatch):
    cell = audit.run_cell("griffin", registry.FAMILY_SMOKE["griffin"], "paged", "cpu")
    fs = [Finding.from_dict(d) for d in cell["findings"]]
    assert cell["status"] == "downgraded" and cell["closures"] == {}
    assert [(f.check, f.level) for f in fs] == [("downgrade", "info")], fs
    monkeypatch.setattr(audit, "EXPECTED_DOWNGRADES", {})
    cell = audit.run_cell("griffin", registry.FAMILY_SMOKE["griffin"], "paged", "cpu")
    fs = [Finding.from_dict(d) for d in cell["findings"]]
    assert [f.where for f in gating(fs)] == ["griffin/paged"], fs


def test_audit_cli_over_one_family_exits_zero(tmp_path, capsys):
    out = tmp_path / "audit.json"
    assert audit.main(["--device", "cpu", "--families", "transformer", "--out", str(out)]) == 0
    import json
    rec = json.loads(out.read_text())
    assert [c["status"] for c in rec["cells"]] == ["audited"] * 3
    assert rec["summary"]["gating"] == 0
    assert all(c["trace"]["completed"] == 12 for c in rec["cells"])
    assert "transformer/fused: audited" in capsys.readouterr().out
