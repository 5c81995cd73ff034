"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2 (arXiv:2402.19427).
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window=2048."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp_kind="geglu",
    window=2048, lru_width=2560, block_pattern=("R", "R", "A"),
    conv_width=4, subquadratic=True,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, window=16, lru_width=64)
