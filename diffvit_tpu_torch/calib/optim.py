"""``optax.adam`` as the JAX package runs it, on one float32 tensor, in its
two forms: compiled with the update under ``jax.jit`` (the recovery passes:
AdaRound's rounding logits, QAT's flat parameter vector), and run op by op
outside any jit (``eager=True``: PSAQ data generation,
``analysis/datagen.py``).

``torch.optim.Adam`` divides ``exp_avg / bc1`` by ``sqrt(exp_avg_sq) /
sqrt(bc2) + eps``: equal to optax's ``mu_hat / (sqrt(nu_hat) + eps)`` in
exact arithmetic, not in float32, and AdaRound's hard decision ``h > 0.5``
can flip on a borderline weight.  So the update is optax's as XLA compiles
it on the CPU: its algebraic simplifier folds the two divisions into one,
and three of its multiply-adds are fused (one rounding each):

    mu = fma(1 - b1, g, b1 * mu);   nu = fma(g * g, 1 - b2, b2 * nu)
    p = fma(mu / ((1 - b1^t) * (sqrt(nu / (1 - b2^t)) + eps)), -lr, p)

with the float32 constants JAX takes from Python numbers, ``b^t`` in
float32 (taken in float64 and rounded once, which is XLA's value at every
step but one of 3,000 on the CPU), the divisions by device tensors (CUDA
torch divides by a Python number through its reciprocal) and the root in
float64 rounded once (CUDA's float32 ``sqrt`` is not correctly rounded).
A fused multiply-add is taken in float64 (the float32 product is exact
there) and rounded once to float32.  Against ``optax.adam`` under
``jax.jit`` on the CPU the parameters stay bit-equal (tests/
test_torch_recovery.py).

Eagerly each operation of optax 0.2.6 is rounded on its own: ``mu = (1 -
b1) * g + b1 * mu`` and ``nu = (1 - b2) * g**2 + b2 * nu`` op by op;
``bias_correction``, its own small jit, ``1 - b^t`` and one true
division; ``m / (sqrt(v) + eps)``; a multiply by ``-lr(count)`` with the
schedule's own count (0 at the first step); then ``p + u``.  Against
``optax.adam`` run so the parameters stay bit-equal too
(tests/test_torch_datagen.py).
"""
from __future__ import annotations

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
F32, F64 = torch.float32, torch.float64


def _fma(a, b, c):
    """``a * b + c`` of float32 operands with one rounding."""
    return (a.to(F64) * b + c.to(F64)).to(F32)


def _bias_corrections(decay: float, steps: int) -> np.ndarray:
    """``1 - decay^t`` for t = 1..steps, in float32 as optax takes it."""
    d = np.float64(np.float32(decay))
    t = np.arange(1, steps + 1, dtype=np.float64)
    return np.float32(1.0) - (d ** t).astype(np.float32)


def _f32(x: float) -> float:
    """The float32 value JAX takes from the Python number ``x``."""
    return float(np.float32(x))


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` on the float32 tensor ``p`` for at
    most ``steps`` steps, under ``jax.jit`` or (``eager``) op by op:
    :meth:`step` updates ``p`` in place from its gradient.  ``lr`` is a
    number or a schedule, ``lr(count) ->`` the float32 rate at the
    step's 0-based count."""

    def __init__(self, p: torch.Tensor, lr, steps: int, b1=B1, b2=B2,
                 eps=EPS, eager=False):
        self.p, self.t, self.eager = p, 0, eager
        self.mu = torch.zeros_like(p)
        self.nu = torch.zeros_like(p)
        bc = np.stack([_bias_corrections(b1, steps),
                       _bias_corrections(b2, steps)], 1)
        self._bc = torch.tensor(bc, device=p.device)
        self._lr = lr if callable(lr) else (lambda _count: lr)
        self._b1, self._b2, self._eps = _f32(b1), _f32(b2), _f32(eps)
        self._c1, self._c2 = _f32(1.0 - b1), _f32(1.0 - b2)

    @torch.no_grad()
    def step(self, g: torch.Tensor) -> None:
        bc1, bc2 = self._bc[self.t]
        neg_lr = _f32(-self._lr(self.t))
        self.t += 1
        if self.eager:
            self.mu = self._c1 * g + self._b1 * self.mu
            self.nu = self._c2 * (g * g) + self._b2 * self.nu
        else:
            self.mu = _fma(g, self._c1, self._b1 * self.mu)
            self.nu = _fma(g * g, self._c2, self._b2 * self.nu)
        root = torch.sqrt((self.nu / bc2).to(F64)).to(F32)
        if self.eager:
            u = neg_lr * ((self.mu / bc1) / (root + self._eps))
            self.p.copy_(self.p + u)
        else:
            self.p.copy_(_fma(self.mu / (bc1 * (root + self._eps)), neg_lr,
                              self.p))
