"""musicgen-medium [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284]

EnCodec frontend is a STUB per spec: input_specs() provides precomputed
frame embeddings / codec token ids; this config is the decoder backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    modality="audio",
    norm="layernorm",
    act="gelu",
    source="arXiv:2306.05284",
)
