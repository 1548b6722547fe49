"""olmoe-1b-7b — fully sparse MoE LM, 64 experts top-8.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8. Every FFN is an MoE with 1024-dim experts.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    qk_norm=True,          # OLMoE uses QK-norm
)
