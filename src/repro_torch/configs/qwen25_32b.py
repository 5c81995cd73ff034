"""qwen2.5-32b [dense] — GQA with QKV bias (hf:Qwen/Qwen2.5-*).
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
