"""musicgen-large — decoder-only LM over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
The EnCodec/conditioning frontend is a STUB: ``input_specs`` supplies
precomputed frame embeddings that a learned projector prefixes to the token
stream (assignment: "modality frontend is a STUB").
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="audio_frames",
    frontend_dim=768,     # conditioning embedding width (T5-style)
    frontend_len=64,      # prefix frames
)
