"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
ViT frontend is a STUB: input_specs() supplies precomputed patch embeddings
plus (t, h, w) position ids for M-RoPE (sections 16/24/24 half-dims)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), input_embeds=True,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mrope_sections=(2, 3, 3))
