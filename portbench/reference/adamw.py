"""AdamW in plain float32 PyTorch, the configuration's rule.

Each step: the gradients are clipped to a global float32 norm of at most
``grad_clip``; the learning rate warms up linearly over ``warmup_steps``;
the moments are float32; decoupled weight decay applies to every leaf;
``p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``, computed in
float32 and stored in the leaf's own type (bfloat16 weights round back).
"""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, dtypes: dict, cfg: dict):
        self.cfg = cfg
        self.dtypes = dtypes
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: dict, grads: dict) -> dict:
        """Update the float32 ``params`` in place; returns the clipped
        gradients' per-leaf norms."""
        c = self.cfg
        self.count += 1
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(grads.values())).device)
        for k in sorted(grads):
            total = total + grads[k].square().sum()
        gnorm = torch.sqrt(total)
        scale = torch.clamp(c["grad_clip"] / (gnorm + 1e-9), max=1.0) \
            if c["grad_clip"] else torch.ones_like(gnorm)
        lr = c["lr"] * min(self.count / max(c["warmup_steps"], 1), 1.0)
        b1c = 1.0 - c["b1"] ** self.count
        b2c = 1.0 - c["b2"] ** self.count
        norms = {}
        for k, p in params.items():
            g = grads[k] * scale
            norms[k] = torch.linalg.vector_norm(g)
            self.mu[k].mul_(c["b1"]).add_(g * (1 - c["b1"]))
            self.nu[k].mul_(c["b2"]).add_(g.square() * (1 - c["b2"]))
            upd = (self.mu[k] / b1c) / ((self.nu[k] / b2c).sqrt() + c["eps"])
            p.sub_((upd + c["weight_decay"] * p) * lr)
            p.copy_(p.to(self.dtypes[k]).float())
        return norms
