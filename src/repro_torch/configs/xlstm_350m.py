"""xlstm-350m — sLSTM + mLSTM recurrent LM (attention-free).

[arXiv:2405.04517; unverified]  24L d_model=1024 4H d_ff=0 vocab=50304.
Alternating mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar memory,
sequential) blocks; d_ff=0 means blocks carry their own up/down projections
(proj_factor=2). Sub-quadratic: runs the long_500k cell.
"""

from ..models.config import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM, SLSTM),
    proj_factor=2.0,
    tie_embeddings=True,
)
