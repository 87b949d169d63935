"""internvl2-26b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821]

Vision frontend (InternViT) is a STUB per spec: input_specs() provides
precomputed patch embeddings; this config is the language backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    modality="vision",
    num_patches=1024,
    source="arXiv:2404.16821",
)
