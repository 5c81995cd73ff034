"""The plain reference against the port's plain CPU path at smoke size (the
port run in float32, so both compute the same equations at the same
precision), and the benchmark's FLOP count against ``FlopCounterMode`` over
the reference."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from servebench import flops, harness
from servebench import weights as W
from servebench.tests.cells import smoke_cell

CELLS = ["codeqwen-decode-c128", "olmoe-decode-c128"]


def _model_and_weights(name, seed=5):
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    cell = smoke_cell(name)
    cfg = harness.ref_config(cell.config)
    base = registry.get_config(cell.config["registry"])
    fields = {f.name for f in dataclasses.fields(base)}
    model = registry.build_model(dataclasses.replace(
        base, **{k: v for k, v in cfg.items() if k in fields}))
    bf16 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    params = W.draw(model.init_params(0, bf16, device="meta"), seed, "cpu", cfg["family"])
    return cfg, model, params


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port_plain_path_in_f32(name):
    from repro_torch.core.cascade import CascadeConfig
    cfg, model, params = _model_and_weights(name)
    f32 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
    toks = torch.randint(0, cfg["vocab"], (1, 48), generator=torch.Generator().manual_seed(1))
    # the serving path (drop-free routing), one chunk into an f32 cache
    cache = model.init_cache(1, 64, dtype=torch.float32, device="cpu")
    port = model.prefill_extend(dict(params, embed={"table": params["embed"]["table"].float()}),
                                {"tokens": toks}, cache, f32, all_logits=True)[0][0]
    ref = harness.reference(cfg["family"]).forward(params, cfg, [toks[0]],
                                                   [torch.arange(48)], q_block=16)[0]
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-4), (port - ref).abs().max()
    # the port in bf16 is near, not equal; the fp8 control is farther
    from repro_torch.core.cascade import CascadeConfig as C
    cache = model.init_cache(1, 64, dtype=torch.bfloat16, device="cpu")
    bf16 = model.prefill_extend(params, {"tokens": toks}, cache,
                                C(mode="serve_fp4", compute_dtype=torch.bfloat16),
                                all_logits=True)[0][0]
    low = harness.reference(cfg["family"]).forward(params, cfg, [toks[0]], [torch.arange(48)],
                                                   precision="fp8")[0]
    assert 0 < (bf16 - ref).abs().max() < (low - ref).abs().max()


@pytest.mark.parametrize("name", CELLS)
def test_flop_count_equals_flop_counter_over_the_reference(name):
    cfg, _, params = _model_and_weights(name)
    s = 37
    toks = torch.randint(0, cfg["vocab"], (s,), generator=torch.Generator().manual_seed(2))
    ref = harness.reference(cfg["family"])
    with FlopCounterMode(display=False) as fc:
        ref.forward(params, cfg, [toks], [torch.arange(s)], q_block=1)
    want = sum(flops.token_flops(cfg, p + 1) for p in range(s)) + s * flops.head_flops(cfg)
    assert fc.get_total_flops() == want
    # a chunk's count is its rows' and one head row; a decode step's, each slot's and a head
    assert flops.chunk_flops(cfg, 0, s) == want - (s - 1) * flops.head_flops(cfg)
    assert flops.decode_flops(cfg, [5, 9]) == (flops.token_flops(cfg, 5) + flops.token_flops(cfg, 9)
                                               + 2 * flops.head_flops(cfg))
