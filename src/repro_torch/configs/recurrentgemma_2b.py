"""recurrentgemma-2b — RG-LRU + local attention hybrid (Griffin), 1:2 ratio.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000. Pattern: two RG-LRU blocks per local-attention block
(26 layers = 2 groups of a 13-block pattern carrying 9 recurrent + 4 local
attention, reproducing the paper's (R,R,A) tiling over 26 layers).
Sub-quadratic (window-bounded cache): runs the long_500k cell.
"""

from ..models.config import ATTN_LOCAL, RGLRU, ModelConfig

_PATTERN = (RGLRU, RGLRU, ATTN_LOCAL) * 4 + (RGLRU,)   # 13 blocks, x2 groups

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=_PATTERN,
    sliding_window=2048,
    lru_dim=2560,
    act="gelu",
    tie_embeddings=True,
)
