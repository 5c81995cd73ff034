"""phi4-mini-3.8b [dense] — RoPE (partial) + SwiGLU + GQA (arXiv:2412.08905).
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, tied embeddings."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064, rope_fraction=0.75, tie_embeddings=True,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
