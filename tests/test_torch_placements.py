"""The dry run's remaining placements on a real two-rank gloo world, on the
CPU (``tests/_torch_placement_ranks.py``, one spawn): ZeRO-1 and FSDP on a
(2, 1) mesh, sequence parallelism and the expert-parallel dispatch on
cascade's bands on a (1, 2) mesh, each against the unsharded step.

* ``zero1`` / ``fsdp``: three steps of the dry run's train cell (the dense
  smoke model, remat, AdamW, f32). The gradients are reduce-scattered onto
  the data bands (ZeRO-1) or reduce-scattered by the per-layer gathers'
  backward (FSDP): a sum of two terms, the same bits as the data-parallel
  all-reduce. The update is elementwise on the band. Only the clip's global
  norm sums its squares in another order (a band's, then the bands'), so
  the gradient norms are held within 1e-6 relative and the params and
  moments within ``ZERO_TOL``; every data-banded leaf holds half its
  elements on a rank (the moments under both; the params under FSDP).
* ``seqpar``: the prefill cell's logits and a loss and its gradients with
  the residual on each rank's rows between blocks, for the dense model
  under cascade (all-to-all back to the rows) and megatron (reduce-scatter),
  the MoE with 16 experts (its expert buffer E over ``model``: the
  column-banded experts re-banded by all-to-all) and Mamba-2, within
  ``SEQPAR_TOL`` of the unsharded model (the row bands' products sum in
  another order than the whole matmul's); each param leaf on its bands.
* ``moe_ep`` on cascade's column-banded experts: the logits of megatron's
  expert bands, within ``SEQPAR_TOL``.
* ``fulldp`` on serving cells (the dry run's prefill and decode cells under
  ``--act-policy fulldp``, 3 rows over the 2-wide model axis, so a rank's
  share is padded): each rank holds its rows between blocks, the params
  keep their cascade bands and the mixers and MLPs run on the gathered
  rows. No sum changes order: the prefill and the decode step of the dense
  model, olmoe (MoE) and Mamba-2 (its SSD state and conv banded over
  ``model``) give the unsharded logits and cache bit for bit. Where
  ``cache_specs`` bands a cache's time or latent rows (recurrentgemma-2b's
  ring, deepseek-v2-236b's MLA latent), decode merges the bands'
  attentions by their log-sum-exps in another order than the unsharded
  softmax (``test_torch_cache_bands.py``): within ``SEQPAR_TOL`` of the
  unsharded step, and bit-equal to the plain cascade cell's.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_placement_ranks as R
from repro_torch.launch import mesh as meshlib

ZERO_TOL = dict(atol=1e-7, rtol=1e-5)
SEQPAR_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    inputs = {"train": rng.integers(0, 256, (4, 33)).astype(np.int32),
              "moe_train": rng.integers(0, 256, (2, 33)).astype(np.int32),
              "prefill": rng.integers(0, 256, (2, 32)).astype(np.int32)}
    inputs["fulldp"] = {arch: rng.integers(0, 256, (3, 13)).astype(np.int32)
                        for arch in R.FULLDP_ARCHS}
    inputs["fulldp_max_len"] = 24
    return meshlib.run_local_ranks(2, R.placement_checks, inputs, timeout=600)


@pytest.mark.parametrize("dp_shard", ["zero1", "fsdp"])
def test_zero_and_fsdp_steps_equal_the_data_parallel_step(world, dp_shard):
    for rank in (0, 1):
        want, got = world[rank][("zero", "none")], world[rank][("zero", dp_shard)]
        assert got["loss"] == want["loss"]
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-6)
        for key in ("params", "mu", "nu"):
            for w, g in zip(want[key], got[key]):
                np.testing.assert_allclose(g, w, err_msg=key, **ZERO_TOL)


@pytest.mark.parametrize("dp_shard", ["zero1", "fsdp"])
def test_each_data_banded_leaf_holds_half_its_bytes(world, dp_shard):
    numel = world[0][("zero", dp_shard)]["numel"]
    for path, (local, whole) in numel.items():
        banded = path[0] == "mu" or dp_shard == "fsdp"
        assert local * (2 if banded else 1) == whole, path


@pytest.mark.parametrize("tp", ["cascade", "megatron"])
def test_seqpar_prefill_logits_equal_the_unsharded_prefill(world, tp):
    for rank in (0, 1):
        want, got = world[rank][("seqpar", "prefill", tp)]["logits"]
        np.testing.assert_allclose(got, want, **SEQPAR_TOL)


@pytest.mark.parametrize("key", [("seqpar", "dense", "cascade"), ("seqpar", "dense", "megatron"),
                                 ("seqpar", "moe16", "cascade"), ("seqpar", "mamba", "cascade")],
                         ids=["dense-cascade", "dense-megatron", "moe16-cascade", "mamba-cascade"])
def test_seqpar_loss_and_gradients_equal_the_unsharded_ones(world, key):
    for rank in (0, 1):
        res = world[rank][key]
        assert res["loss"][1] == pytest.approx(res["loss"][0], rel=1e-6)
        for want, got in res["grads"]:
            np.testing.assert_allclose(got, want, **SEQPAR_TOL)
        assert sum(local for local, _ in res["numel"]) < sum(whole for _, whole in res["numel"])


def test_moe_ep_on_cascade_bands_equals_expert_bands(world):
    for rank in (0, 1):
        out = world[rank]["moe_ep"]
        np.testing.assert_allclose(out["cascade"], out["megatron"], **SEQPAR_TOL)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list(R.FULLDP_ARCHS))
def test_fulldp_serving_cell_equals_the_unsharded_step(world, arch, kind):
    merged = kind == "decode" and R.FULLDP_ARCHS[arch]
    for rank in (0, 1):
        res = world[rank][("fulldp", arch)]
        (want, got), (cache_want, cache_got) = res[kind]["logits"], res[kind]["cache"]
        assert set(cache_got) == set(cache_want)
        if merged:
            np.testing.assert_allclose(got, want, **SEQPAR_TOL)
            plain, plain_cache = res["cascade_cell"]
            np.testing.assert_array_equal(got, plain)
        else:
            np.testing.assert_array_equal(got, want)
        for name, w in cache_want.items():
            if merged:
                np.testing.assert_allclose(cache_got[name], w, err_msg=name, **SEQPAR_TOL)
                np.testing.assert_array_equal(cache_got[name], plain_cache[name], err_msg=name)
            else:
                np.testing.assert_array_equal(cache_got[name], w, err_msg=name)


def test_fulldp_decode_runs_against_a_cache_banded_over_model(world):
    """Every family's decode cache holds bands over ``model`` (KV heads, a
    ring's time rows, MLA's latent rows, the SSD state and conv channels)."""
    bands = {arch: world[0][("fulldp", arch)]["bands"] for arch in R.FULLDP_ARCHS}
    assert bands == {"codeqwen1.5-7b": ["layers/k", "layers/v"],
                     "olmoe-1b-7b": ["layers/k", "layers/v"],
                     "mamba2-370m": ["layers/conv", "layers/state"],
                     "recurrentgemma-2b": ["attn/k", "attn/v", "layers/conv", "layers/h"],
                     "deepseek-v2-236b": ["layers/c_kv", "layers/k_rope"]}
