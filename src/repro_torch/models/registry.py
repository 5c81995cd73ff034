"""arch id -> (config, model constructor)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# CLI ids use dashes matching the assignment table
ALIASES = {
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2.5-32b": "qwen25_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "nemotron-4-15b": "nemotron4_15b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

#: one representative arch per serving family
FAMILY_SMOKE = {
    "transformer": "codeqwen1.5-7b",
    "moe": "deepseek-v2-236b",        # MLA latent cache + routed experts
    "griffin": "recurrentgemma-2b",   # ring-buffer KV + RG-LRU state
    "ssm": "mamba2-370m",             # conv + SSD state
}

#: families the port does not build yet, and the ROADMAP item that ports each
_NOT_PORTED = {
    "audio": "ROADMAP Queue 1 item 6 (sinusoidal positions and the "
             "multi-codebook head of TransformerLM)",
    "vlm": "ROADMAP Queue 1 item 6 (M-RoPE in models/layers.py)",
}


def canonical(arch_id: str) -> str:
    return ALIASES.get(arch_id, arch_id)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.smoke() if smoke else mod.CONFIG


def build_model(cfg: ArchConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to PyTorch "
            f"yet; see {_NOT_PORTED[cfg.family]}")
    if cfg.family == "ssm":
        from repro_torch.models.ssm import Mamba2LM
        return Mamba2LM(cfg)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.griffin import GriffinLM
        return GriffinLM(cfg)
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg)


def load(arch_id: str, smoke: bool = False):
    cfg = get_config(arch_id, smoke)
    return cfg, build_model(cfg)
