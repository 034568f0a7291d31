"""The two optimizers of `skyhdr.train.engine`, written out by hand, with its
three storage knobs (`TrainConfig.opt_state_dtype`, `grad_dtype`,
`param_dtype`).

  RMSprop — optax 0.2.6 `rmsprop(lr, decay=0.9, eps=1e-7)`: eps inside the
            square root, nu starting at 0, no bias correction:
              nu = 0.9 nu + 0.1 g^2;  p -= lr * g * rsqrt(nu + 1e-7).
            (`torch.optim.RMSprop` puts eps outside the root.)
  Adam    — optax `adam(lr, b1=0.9, b2=0.999, eps=1e-7)` with bias
            correction: p -= lr * mu_hat / (sqrt(nu_hat) + 1e-7), the
            corrections 1 - b^count computed in float32, as optax does.

`step(grads)` updates the parameters in place under `no_grad`, in the order
of `params`, one leaf at a time and within a leaf `CHUNK` elements at a
time, in place where the bits allow it: a float32 moment is updated where
it lies, a bfloat16 one costs a float32 temporary of one stretch, never of
a leaf or a tree.

The knobs, as `skyhdr`'s `_with_param_master(_with_state_dtype(tx))` runs
them:
  opt_state_dtype — the moments are stored in it; each step upcasts them,
      updates them in float32, computes the update from the new float32
      moments and only then rounds them for storage. Adam's count stays an
      int.
  grad_dtype      — the gradient arrives in it (the train step casts).
      With float32 parameters a bfloat16 gradient reaches optax as is, and
      the moment terms round where optax's dtypes put them: g^2,
      (1 - decay) g^2 and (1 - b1) g in bfloat16 (the constant rounded to
      bfloat16 first, as a weakly typed Python scalar is), the sums with
      the float32 moments in float32.
  param_dtype     — "bfloat16" stores the parameters in bfloat16 and keeps a
      float32 master of each in the optimizer: the gradient is upcast, the
      update applied to the master, and the parameter written as
      round_bf16(master). The master is float32 whatever opt_state_dtype
      says (the master wrapper sits outside the moments' one).

`state()` lists the moments (Adam's count, the master) for a checkpoint,
each tensor in its own dtype; `load_moments(state)` copies such a list
back in. A loaded moment keeps its value exactly: one loaded into a
bfloat16-storing optimizer from float32 stays float32 until the next step
rounds it, as `skyhdr`'s restore keeps the saved dtype and its next update
rounds. `moments()` maps each parameter to its moments and master, for
export.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}
# Elements a step updates at once: every operation is elementwise, so a
# leaf goes through in stretches of this many with the same bits, and a
# temporary holds one stretch (64 MiB in float32), never a whole 2.15 GB
# fc1 kernel. Stretches of 2^22 elements made the sun step's Adam
# launch-bound on an H100.
CHUNK = 1 << 24


def storage_dtype(name: Optional[str]) -> torch.dtype:
    """The torch dtype of a knob's value (None and "float32": float32)."""
    if name not in _DTYPES:
        raise ValueError(f"storage dtype {name!r}: neither float32 nor bfloat16")
    return _DTYPES[name]


def _weak(c: float, like: torch.Tensor) -> float:
    """The Python constant `c` as JAX multiplies a `like` array by it:
    rounded to that array's dtype."""
    return float(torch.tensor(c, dtype=like.dtype))


def _term(g: torch.Tensor, decay: float, order: int) -> torch.Tensor:
    """optax's `(1 - decay) * g**order`, in g's dtype."""
    if order == 1:
        return g * _weak(1.0 - decay, g)
    t = g * g
    return t.mul_(_weak(1.0 - decay, t))


def bias_correction(decay: float, count: int) -> float:
    """optax's `1 - decay**count` in float32, as a Python float."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


class _Optimizer:
    """The moments and the master of one optimizer; subclasses name the
    moments in `MOMENTS` and define `_decay_order` and `_update`."""

    MOMENTS: tuple = ()

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 opt_state_dtype: Optional[str] = "float32",
                 param_dtype: Optional[str] = "float32"):
        self.params = list(params)
        self.lr = lr
        self.store = storage_dtype(opt_state_dtype)
        master = storage_dtype(param_dtype) != torch.float32
        for p in self.params:
            if p.dtype != storage_dtype(param_dtype):
                raise ValueError(f"a {p.dtype} parameter under param_dtype={param_dtype!r}")
        for name in self.MOMENTS:
            setattr(self, name, [torch.zeros_like(p, dtype=self.store) for p in self.params])
        # The float32 weights the update is applied to (None: the
        # parameters themselves); `create_*_state` fills it.
        self.master = ([torch.empty_like(p, dtype=torch.float32) for p in self.params]
                       if master else None)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self._begin()
        for i, (p, g) in enumerate(zip(self.params, grads)):
            w = p if self.master is None else self.master[i]
            moments = [getattr(self, name)[i] for name in self.MOMENTS]
            g = g.reshape(-1)
            for a in range(0, p.numel(), CHUNK):
                sl = slice(a, a + CHUNK)
                self._step_chunk(p.view(-1)[sl], g[sl], [m.view(-1)[sl] for m in moments],
                                 w.view(-1)[sl])
            for name, m in zip(self.MOMENTS, moments):
                if m.dtype != self.store:  # a float32 moment loaded into a bfloat16 optimizer
                    getattr(self, name)[i] = m.to(self.store)

    def _step_chunk(self, p, g, moments, w) -> None:
        """One stretch of one leaf (every argument a flat view of the same
        elements): the new float32 moments, the update from them applied
        to `w`, then the moments stored and the parameter written."""
        if self.master is not None:
            g = g.float()
        new = [self._moment(name, m, g) for name, m in zip(self.MOMENTS, moments)]
        w.add_(self._update(g, *new))
        for m, value in zip(moments, new):
            if m is not value:
                m.copy_(value)
        if self.master is not None:
            p.copy_(w)

    def _moment(self, name: str, m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The new float32 moment: optax's `(1 - decay) * g**order + decay *
        m`, in place when the moment is stored in float32 (the float32 sum
        is commutative, so decay * m + term is the same bits)."""
        decay, order = self._decay_order(name)
        return m.float().mul_(decay).add_(_term(g, decay, order))

    def _begin(self) -> None:
        pass

    @torch.no_grad()
    def sync_params(self) -> None:
        """Write every parameter as its master rounded to the parameter's
        dtype (after the master was filled or replaced)."""
        for p, m in zip(self.params, self.master or ()):
            p.copy_(m)

    def moments(self) -> dict:
        """{moment name: {param: tensor}}, with "master" when there is one."""
        out = {name: dict(zip(self.params, getattr(self, name))) for name in self.MOMENTS}
        if self.master is not None:
            out["master"] = dict(zip(self.params, self.master))
        return out

    def hold_moments(self, dtype: torch.dtype) -> None:
        """Reallocate the moments (zero) in `dtype`: an import holds
        float32 moments in a bfloat16-storing optimizer this way until the
        next step rounds them."""
        for name in self.MOMENTS:
            setattr(self, name, [torch.zeros_like(m, dtype=dtype)
                                 for m in getattr(self, name)])

    def state(self) -> dict:
        out = {name: list(getattr(self, name)) for name in self.MOMENTS}
        if self.master is not None:
            out["master"] = list(self.master)
        return out

    def load_moments(self, state: dict) -> None:
        for name in self.MOMENTS:
            _load_into(getattr(self, name), state[name], name)
        if (self.master is None) != ("master" not in state):
            raise ValueError("the optimizer state " + ("lacks" if self.master is not None
                                                       else "holds") +
                             " a float32 master: it was saved under another param_dtype")
        if self.master is not None:
            _load_into(self.master, state["master"], "master")


class RMSprop(_Optimizer):

    MOMENTS = ("nu",)

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 decay: float = 0.9, eps: float = 1e-7, **dtypes):
        super().__init__(params, lr, **dtypes)
        self.decay, self.eps = decay, eps

    def _decay_order(self, name):
        return self.decay, 2

    def _update(self, g, nu):
        """g * rsqrt(nu + eps) * -lr."""
        return (nu + self.eps).rsqrt_().mul_(g).mul_(-self.lr)


class Adam(_Optimizer):

    MOMENTS = ("mu", "nu")

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7, **dtypes):
        super().__init__(params, lr, **dtypes)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0

    def _begin(self) -> None:
        self.count += 1
        self._c1 = bias_correction(self.b1, self.count)
        self._c2 = bias_correction(self.b2, self.count)

    def _decay_order(self, name):
        return (self.b1, 1) if name == "mu" else (self.b2, 2)

    def _update(self, g, mu, nu):
        """mu_hat / (sqrt(nu_hat) + eps) * -lr."""
        den = (nu / self._c2).sqrt_().add_(self.eps)
        return (mu / self._c1).div_(den).mul_(-self.lr)

    def state(self) -> dict:
        return {"count": self.count, **super().state()}

    def load_moments(self, state: dict) -> None:
        super().load_moments(state)
        self.count = int(state["count"])


@torch.no_grad()
def _load_into(dst: list, src: Sequence[torch.Tensor], name: str):
    """Copy `src` into the tensors of `dst`, each keeping its value exactly:
    into the tensor when its dtype holds the value (the same dtype, or
    float32), else `dst` takes a float32 copy in its place."""
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} tensors for {len(dst)} parameters")
    for i, (d, s) in enumerate(zip(dst, src)):
        if d.shape != s.shape:
            raise ValueError(f"{name}[{i}]: shape {tuple(s.shape)} != {tuple(d.shape)}")
        if s.dtype == d.dtype or d.dtype == torch.float32:
            d.copy_(s)
        else:
            dst[i] = s.to(device=d.device, dtype=torch.float32, copy=True)
