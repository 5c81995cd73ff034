"""The serve CLI's ``--audit`` (the reference's ``launch/serve.py`` flag) and
the exit code of a local world, on the CPU.

* ``--smoke --device cpu --audit`` prints one ``audit <closure>:`` line for
  every step closure of the engine it built, then the findings and the
  summary, exits 0, and serves. The closures are the reference engine's
  ``step_closures()`` for the same configuration (dense, prefix-cached,
  speculative), plus the port's ``pick``.
* A closure with a planted host read exits 1 before anything is served,
  names the closure and prints ``SERVING CONTRACT VIOLATED``.
* ``--audit --traffic`` exits 2; a slot-wise engine gives the reference's
  info finding and passes.
* Under ``--host-devices 2 --mesh 1x2`` every rank audits its own engine;
  a check that fails on rank 1 alone makes the run exit 1 and print rank
  1's FAIL lines with its number, and no rank serves.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_mesh_ranks as R
from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core.cascade import CascadeConfig
from repro_torch.launch import serve as scli
from repro_torch.models import registry
from repro_torch.serve.engine import ServeConfig, ServeEngine

jax.config.update("jax_platform_name", "cpu")

SERVE = ["--smoke", "--device", "cpu", "--requests", "2", "--max-new", "3", "--audit"]
MODES = {"dense": [], "prefix": ["--prefix-cache", "--page-size", "4"],
         "spec": ["--draft-len", "3"]}


def _audited(out: str) -> list:
    return sorted(ln.split(":")[0].split()[1] for ln in out.splitlines()
                  if ln.startswith("audit ") and not ln.startswith("audit: "))


def _reference_closures(extra: list) -> list:
    """The reference engine's step closures for the CLI's configuration."""
    cfg, model = jregistry.load("codeqwen1.5-7b", smoke=True)
    params = model.init_params(jax.random.PRNGKey(0),
                               JCascadeConfig(mode="train", compute_dtype=jnp.float32))
    ccfg = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
    args = scli.parser().parse_args(SERVE + extra)
    eng = JServeEngine(model, jcascade.tree_to_serve_fp4(params, ccfg), ccfg, JServeConfig(
        max_batch=args.max_batch, max_len=args.prompt_len + args.max_new + 1,
        draft_len=args.draft_len, prefix_cache=args.prefix_cache, page_size=args.page_size))
    return sorted(eng.step_closures())


@pytest.mark.parametrize("mode", list(MODES))
def test_audit_prints_every_closure_and_serves(capsys, mode):
    assert scli.main(SERVE + MODES[mode]) == 0
    out = capsys.readouterr().out
    assert _audited(out) == sorted(_reference_closures(MODES[mode]) + ["pick"])
    n = len(_audited(out))
    assert f"audit: {n} closure(s), " in out and out.count(" 0 gating") == 1
    assert "[info] collective-budget: engine" in out          # no mesh: said, not silent
    assert "SERVING CONTRACT VIOLATED" not in out
    assert "served 2 requests" in out


class PlantedHostRead(ServeEngine):
    """The engine with a read to the host inside its decode closure."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        decode = self._decode_fn

        def planted(params, toks, cache, bt=None):
            int(toks.sum())
            return decode(params, toks, cache, bt)
        self._decode_fn = planted


def test_a_planted_host_read_exits_one_naming_the_closure(capsys, monkeypatch):
    monkeypatch.setattr(scli, "ServeEngine", PlantedHostRead)
    assert scli.main(SERVE) == 1
    out = capsys.readouterr().out
    assert "[error] host-read: decode:" in out
    assert "audit decode: in_place=2/2 host_xfer=0 host_reads=1 " in out
    assert out.splitlines()[-1] == "SERVING CONTRACT VIOLATED"
    assert "audit: 4 closure(s)" in out and " 1 gating" in out
    assert "served" not in out                    # held before anything is served


def test_audit_with_traffic_exits_two(capsys):
    assert scli.main(SERVE + ["--traffic"]) == 2
    assert "--audit" in capsys.readouterr().err


def test_a_slotwise_engine_gives_the_info_finding():
    cfg, model = registry.load("codeqwen1.5-7b", smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
    eng = ServeEngine(model, model.init_params(0, ccfg, device="cpu"), ccfg,
                      ServeConfig(max_batch=2, max_len=16, batched=False), device="cpu")
    lines, fails = scli.audit(eng)
    assert fails == []
    assert lines[0].startswith("[info] audit: engine") and "slot-wise" in lines[0]
    assert lines[-1] == "audit: 0 closure(s), 1 finding(s), 0 gating"


def test_a_failure_on_rank_one_alone_fails_the_local_world(capsys):
    """Every rank audits its own engine (the cascade audit is clean on
    both); the planted check fails on rank 1 only: the exit code is the
    largest of the ranks', rank 1's FAIL line is printed with its number,
    and no rank serves."""
    argv = SERVE + ["--host-devices", "2", "--mesh", "1x2"]
    assert scli.main(argv, checks=(R.fail_on_rank_one,)) == 1
    out = capsys.readouterr().out
    assert _audited(out) == ["decode", "extend", "pick", "write"]     # rank 0's lines
    assert "audit: 4 closure(s), " in out and out.count(" 0 gating") == 1
    assert "not served: the checks failed on another rank" in out
    assert "rank 1 of 2: exit 1" in out and "rank 0 of 2" not in out
    assert "rank 1: FAIL: planted check on rank 1" in out
    assert "served 2 requests" not in out
