"""HF ``transformers.optimization.Adafactor`` as the reference trains with
it (``Adafactor(params, warmup_init=True)``: relative step, parameter
scale, no first moment, no weight decay), written from its published
update rule:

    rel_step = min(1e-6 * t, 1 / sqrt(t))            (warmup_init)
    lr       = max(1e-3, RMS(p)) * rel_step
    beta2_t  = 1 - t ** -0.8
    v        = beta2_t v + (1 - beta2_t) (g^2 + 1e-30), factored into row
               and column means for every parameter of two or more dims
    u        = g / sqrt(v)  (factored: rows normalised by their mean)
    u       /= max(1, RMS(u) / 1.0)
    p       -= lr u
"""

from __future__ import annotations

from typing import Dict

import torch


class Adafactor:
    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = params
        self.state: Dict[str, dict] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        t = self.t
        rel_step = min(1e-6 * t, 1.0 / t ** 0.5)
        beta2t = 1.0 - t ** -0.8
        for name, p in self.params.items():
            g = grads[name]
            st = self.state.setdefault(name, {})
            lr = max(1e-3, float(p.square().mean().sqrt())) * rel_step
            sq = g.square() + 1e-30
            if p.ndim >= 2:
                row = st.get("row", torch.zeros_like(sq.mean(-1)))
                col = st.get("col", torch.zeros_like(sq.mean(-2)))
                st["row"] = row = beta2t * row + (1 - beta2t) * sq.mean(-1)
                st["col"] = col = beta2t * col + (1 - beta2t) * sq.mean(-2)
                r = (row / row.mean(-1, keepdim=True)).rsqrt()[..., None]
                u = r * col.rsqrt()[..., None, :] * g
            else:
                v = st.get("v", torch.zeros_like(sq))
                st["v"] = v = beta2t * v + (1 - beta2t) * sq
                u = v.rsqrt() * g
            u = u / max(1.0, float(u.square().mean().sqrt()))
            p -= lr * u
