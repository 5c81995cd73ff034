"""olmoe-1b-7b [moe] — 64 experts top-8 (arXiv:2409.02060).
16L d_model=2048 16H (MHA kv=16) per-expert d_ff=1024 vocab=50304."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    n_experts=64, n_shared_experts=0, moe_top_k=8, moe_d_ff=1024,
    moe_renorm=False,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        n_experts=8, moe_top_k=2, moe_d_ff=32, vocab=256)
