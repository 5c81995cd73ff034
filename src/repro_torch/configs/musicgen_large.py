"""musicgen-large [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).
48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048, 4 codebooks.
EnCodec frontend is a STUB: input_specs() supplies precomputed frame
embeddings (sum of the 4 codebook embeddings); sinusoidal positions."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, mlp_kind="gelu", norm_type="layernorm",
    rope_fraction=0.0, n_codebooks=4, input_embeds=True,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=32, n_codebooks=2)
