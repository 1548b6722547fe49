"""gemma2-9b — dense LM with local/global alternating attention + softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000. Attention logit softcap 50, final logit softcap 30,
4096-token sliding window on local layers, tied embeddings, GeGLU.
"""

from ..models.config import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=(ATTN_LOCAL, ATTN),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
