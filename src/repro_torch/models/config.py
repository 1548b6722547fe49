"""Model configuration covering every assigned architecture family.

One frozen dataclass drives dense / MoE / SSM / hybrid / VLM / audio decoder
stacks. Layer heterogeneity (gemma2 local↔global alternation, recurrentgemma's
RG-LRU:attention 1:2 pattern, xLSTM's sLSTM/mLSTM mix) is expressed as a
``block_pattern`` that tiles across ``num_layers`` and is scanned group-wise
(stacked params per pattern period) to keep HLO size and compile time bounded.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

# block kinds
ATTN = "attn"            # global attention
ATTN_LOCAL = "attn_local"
MLSTM = "mlstm"
SLSTM = "slstm"
RGLRU = "rglru"

ATTENTION_KINDS = (ATTN, ATTN_LOCAL)
RECURRENT_KINDS = (MLSTM, SLSTM, RGLRU)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # --- attention variants ---
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2.5
    attn_softcap: float = 0.0        # gemma2: 50.0
    final_softcap: float = 0.0       # gemma2: 30.0
    sliding_window: int = 0          # local-attention window
    rope_theta: float = 10_000.0

    # --- block pattern (tiles over num_layers); () -> all-ATTN ---
    block_pattern: tuple[str, ...] = ()

    # --- misc ---
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # modality frontend stub: precomputed embeddings projected into d_model
    frontend: str = ""               # "" | audio_frames | vision_patches
    frontend_dim: int = 0            # incoming embedding dim
    frontend_len: int = 0            # prefix length supplied by the stub
    # recurrent block sizing
    lru_dim: int = 0                 # 0 -> d_model (RG-LRU width)
    proj_factor: float = 2.0         # xLSTM up-projection factor

    # --- training ---
    dtype: str = "bfloat16"
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", (ATTN,))
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"block pattern period {len(self.block_pattern)}")
        if self.lru_dim == 0:
            object.__setattr__(self, "lru_dim", self.d_model)

    # ---- derived ----
    @property
    def layers_per_group(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.layers_per_group

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no block requires a full-length global KV cache."""
        return all(k != ATTN for k in self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        n = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model     # head
        if self.frontend:
            n += self.frontend_dim * self.d_model   # frontend projector
        per_pattern = 0
        for kind in self.block_pattern:
            per_pattern += self._block_params(kind)
        n += per_pattern * self.num_groups
        n += self.d_model                            # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full_experts = self._moe_ffn_params()
        active = full_experts * self.experts_per_token // self.num_experts
        dense_rest = self.param_count() - full_experts * self.num_layers // \
            self.layers_per_group * self.layers_per_group
        # simpler: subtract all expert params, add back active fraction
        total = self.param_count()
        expert_total = full_experts * self.num_layers
        return total - expert_total + active * self.num_layers

    def _moe_ffn_params(self) -> int:
        return self.num_experts * 3 * self.d_model * self.moe_d_ff

    def _block_params(self, kind: str) -> int:
        d, dff = self.d_model, self.d_ff
        if kind in ATTENTION_KINDS:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                attn += self.q_dim + 2 * self.kv_dim
            if self.qk_norm:
                attn += 2 * self.head_dim
            ffn = (self._moe_ffn_params() + self.num_experts * d  # router
                   if self.is_moe else 3 * d * dff)
            return attn + ffn + 2 * d  # two norms
        if kind == RGLRU:
            r = self.lru_dim
            block = 2 * d * r + r * d       # in (x,gate) + out proj
            block += 3 * r                  # Λ, input-gate, conv-ish mixing
            ffn = 3 * d * dff
            return block + ffn + 2 * d
        if kind == MLSTM:
            up = int(self.proj_factor * d)
            inner = 2 * d * up + up * d     # up (x2) + down
            inner += 3 * up * up // max(self.num_heads, 1)  # q,k,v per head (approx)
            inner += 2 * up                 # gates
            return inner + d
        if kind == SLSTM:
            inner = 4 * d * d + 4 * d * d   # 4 gates, input+recurrent
            ffn_up = int(self.proj_factor * d)
            return inner + 2 * d * ffn_up + d
        raise ValueError(kind)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def scaled_down(self, layers: int = 2, width_div: int = 8,
                    vocab: int = 512) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = len(self.block_pattern)
        layers = max(layers, period)
        layers -= layers % period
        d_model = max(64, self.d_model // width_div)
        n_heads = max(1, self.num_heads // width_div)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        hd = max(16, d_model // n_heads)
        d_model = hd * n_heads
        return self.replace(
            num_layers=layers, d_model=d_model, num_heads=n_heads,
            num_kv_heads=n_kv, head_dim=hd,
            d_ff=max(32, self.d_ff // width_div) if self.d_ff else 0,
            vocab_size=vocab,
            num_experts=min(self.num_experts, 8) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            moe_d_ff=max(32, self.moe_d_ff // width_div) if self.is_moe else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend else 0,
            frontend_len=min(self.frontend_len, 8) if self.frontend else 0,
            lru_dim=max(32, self.lru_dim // width_div),
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
