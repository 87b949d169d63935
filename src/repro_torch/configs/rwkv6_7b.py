"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    ssm_heads=64,                # rwkv6 head_size 64 -> 4096/64 heads
    source="arXiv:2404.05892",
)
