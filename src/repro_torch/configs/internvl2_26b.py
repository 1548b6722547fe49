"""internvl2-26b — VLM: InternViT frontend + InternLM2 decoder backbone.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The InternViT-6B vision tower is a STUB per the assignment:
``input_specs`` supplies precomputed patch embeddings (3200-dim) projected
into the LM as a 256-token prefix.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_patches",
    frontend_dim=3200,    # InternViT-6B feature width
    frontend_len=256,     # patches per image after pixel-shuffle
)
