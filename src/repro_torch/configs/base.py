"""Architecture + shape configuration schema (pure dataclasses, no framework).

One ``ArchConfig`` per assigned architecture (exact public configs) plus a
``smoke()`` reduction of the same family for CPU tests. Field for field the
same schema as the JAX package's ``configs/base.py``, so a config prints and
compares identically on both sides of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"     # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    d_inner: int = 0
    ssm_chunk: int = 128
    # --- hybrid (recurrentgemma / griffin) ---
    window: int = 0              # local-attention window
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("R", "R", "A")
    # --- moe ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0            # per-expert ffn dim
    first_dense_layers: int = 0  # deepseek-v2: layer 0 is a dense MLP
    dense_d_ff: int = 0          # ffn dim of those dense layers
    moe_capacity_factor: float = 1.25
    moe_renorm: bool = True
    # --- mla (deepseek-v2) ---
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- modality stubs ---
    n_codebooks: int = 0         # musicgen: parallel codebook heads
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl (half-dim units)
    input_embeds: bool = False   # stub frontend supplies (B, S, d) embeddings
    # --- implementation knobs ---
    q_chunk: int = 1024          # chunked-attention query block for long prefill
    scan_layers: bool = True
    subquadratic: bool = False   # supports the long_500k shape

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
