"""Llama 3.1 405B — the paper's own example model (Tables 8/9/10).
Used by the benchmark harness to reproduce the paper's FLOP and
weight-loading analysis; not an assigned dry-run architecture."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.1-405b", family="dense",
    n_layers=80, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=65536, vocab=128000, rope_theta=5e5,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256)
