"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

38 layers: mostly mamba2 blocks with a shared full-attention block invoked
every 6 layers (zamba2's shared-weights pattern, modeled as `shared_attn`).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(
    "shared_attn" if (i % 6 == 5) else "mamba" for i in range(38)
)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,             # GQA kv=32 -> MHA in the shared blocks
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    block_pattern=_PATTERN,
    source="arXiv:2411.15242",
)
