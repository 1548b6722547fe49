"""The traffic generator: training batches made on the card from the seed.

A traffic file gives the batch (sequences a step), the sequence length in
tokens and the range of the Zipf exponents of the rows. Every row draws
its own exponent from that range once a run, and every step draws its
tokens anew: rank r of a row's distribution has weight 1 / r^a, and the
ranks map to token ids through one permutation of the vocabulary drawn
from the seed. Each step's tokens, and its conditioning frames (standard
normal, float32) where the model takes a prefix, come from a generator
seeded by (seed, step), so any step can be made again in any order.

``Feed`` has the data pipeline's interface that the trainer reads:
``batch_at(step)``, ``state.step``, ``state_dict()`` and
``load_state_dict()``; its state is the step counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MIX = 0x9E3779B97F4A7C15


def generator(seed: int, *tags: int, device="cuda") -> torch.Generator:
    """A generator seeded from ``seed`` and ``tags`` (any whole numbers)."""
    x = seed & (2 ** 64 - 1)
    for t in tags:
        x = (x * _MIX + t + 1) % 2 ** 63
    g = torch.Generator(device=device)
    g.manual_seed(x)
    return g


@dataclass
class FeedState:
    step: int = 0


class Feed:
    TAG_ROWS, TAG_STEP = 1, 2

    def __init__(self, traffic: dict, model: dict, seed: int, device="cuda"):
        self.B, self.S = traffic["batch"], traffic["seq_len"]
        self.seed, self.device = seed, device
        self.frames = (model.get("frontend_len", 0),
                       model.get("frontend_dim", 0))
        V = model["vocab_size"]
        g = generator(seed, self.TAG_ROWS, device=device)
        lo, hi = traffic["zipf"]
        a = lo + (hi - lo) * torch.rand(self.B, 1, generator=g,
                                        device=device, dtype=torch.float64)
        ranks = torch.arange(1, V + 1, device=device, dtype=torch.float64)
        cdf = torch.cumsum(ranks[None, :] ** -a, dim=1)
        self.cdf = (cdf / cdf[:, -1:]).float()
        self.perm = torch.randperm(V, generator=g, device=device)
        self.state = FeedState()

    def batch_at(self, step: int) -> dict:
        g = generator(self.seed, self.TAG_STEP, step, device=self.device)
        u = torch.rand(self.B, self.S + 1, generator=g, device=self.device)
        ids = torch.searchsorted(self.cdf, u).clamp_max_(
            self.cdf.shape[1] - 1)
        ids = self.perm[ids].to(torch.int32)
        out = {"tokens": ids[:, :-1].contiguous(),
               "labels": ids[:, 1:].contiguous()}
        F, fd = self.frames
        if F:
            out["frontend_embeds"] = torch.randn(
                self.B, F, fd, generator=g, device=self.device)
        return out

    def state_dict(self) -> dict:
        return {"data_step": self.state.step}

    def load_state_dict(self, d: dict) -> None:
        self.state.step = int(d["data_step"])
