"""mamba2-370m [ssm] — SSD state-space duality (arXiv:2405.21060).
48L d_model=1024, attention-free, ssm_state=128, vocab=50280."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_groups=1,
    d_inner=2048, conv_width=4, tie_embeddings=True,
    subquadratic=True,
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_inner=128, ssm_state=16, ssm_head_dim=32, vocab=256, ssm_chunk=8)
