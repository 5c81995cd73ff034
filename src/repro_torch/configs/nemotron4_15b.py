"""nemotron-4-15b [dense] — squared-ReLU MLP, partial RoPE (arXiv:2402.16819).
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000, mlp_kind="relu2", norm_type="layernorm",
    rope_fraction=0.5,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
