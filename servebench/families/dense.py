"""The dense transformer family (codeqwen1.5-7b): attention and a SwiGLU MLP
in every layer, every linear on the FP4 matmul kernel."""
from servebench import flops

#: the kernels a fused serving step launches, built together at set-up
KERNELS = ("cascade_matmul", "decode_attention", "flash_attention", "norm")
#: weight leaves beyond the common ones (``weights.py``): none
LEAVES: dict = {}


def dense_linears(cfg: dict) -> list:
    """The FP4 linears (K, N, bias) one token passes through in a layer."""
    return flops.attn_linears(cfg) + flops.mlp_linears(cfg)


def token_params(cfg: dict) -> int:
    """Matmul parameters one token passes through, the head left out."""
    return cfg["n_layers"] * sum(k * n for k, n, _ in dense_linears(cfg))
