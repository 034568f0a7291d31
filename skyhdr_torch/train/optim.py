"""The two optimizers of `skyhdr.train.engine`, written out by hand.

  RMSprop — optax 0.2.6 `rmsprop(lr, decay=0.9, eps=1e-7)`: eps inside the
            square root, nu starting at 0, no bias correction:
              nu = 0.9 nu + 0.1 g^2;  p -= lr * g * rsqrt(nu + 1e-7).
            (`torch.optim.RMSprop` puts eps outside the root.)
  Adam    — optax `adam(lr, b1=0.9, b2=0.999, eps=1e-7)` with bias
            correction: p -= lr * mu_hat / (sqrt(nu_hat) + 1e-7).

Moments are float32 tensors beside each parameter; `step(grads)` updates
the parameters in place under `no_grad`, in the order of `params`.
`state()` lists the moments (and Adam's count) for a checkpoint, and
`load_moments(state)` copies such a list back in.
"""

from __future__ import annotations

from typing import Sequence

import torch


class RMSprop:

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 decay: float = 0.9, eps: float = 1e-7):
        self.params = list(params)
        self.lr, self.decay, self.eps = lr, decay, eps
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g, nu in zip(self.params, grads, self.nu):
            g = g.float()
            nu.copy_((1.0 - self.decay) * (g * g) + self.decay * nu)
            p.add_((g * torch.rsqrt(nu + self.eps)) * -self.lr)

    def moments(self) -> dict:
        """{"nu": {param: moment}}, for export."""
        return {"nu": dict(zip(self.params, self.nu))}

    def state(self) -> dict:
        return {"nu": list(self.nu)}

    def load_moments(self, state: dict) -> None:
        _copy_into(self.nu, state["nu"], "nu")


class Adam:

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps) * -self.lr)

    def moments(self) -> dict:
        return {"mu": dict(zip(self.params, self.mu)),
                "nu": dict(zip(self.params, self.nu))}

    def state(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_moments(self, state: dict) -> None:
        _copy_into(self.mu, state["mu"], "mu")
        _copy_into(self.nu, state["nu"], "nu")
        self.count = int(state["count"])


@torch.no_grad()
def _copy_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor], name: str):
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} moments for {len(dst)} parameters")
    for i, (d, s) in enumerate(zip(dst, src)):
        if d.shape != s.shape:
            raise ValueError(f"{name}[{i}]: shape {tuple(s.shape)} != {tuple(d.shape)}")
        d.copy_(s)
