"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    source="hf:Qwen/Qwen3-8B",
)
