"""``optax.adam`` as the JAX package's recovery passes run it, on one float32
tensor (AdaRound's rounding logits, QAT's flat parameter vector).

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


class Adam:
    """``optax.adam(lr)`` on the float32 tensor ``p`` for at most ``steps``
    steps: :meth:`step` updates ``p`` in place from its gradient."""

    def __init__(self, p: torch.Tensor, lr: float, steps: int):
        self.p, self.t = p, 0
        self.mu = torch.zeros_like(p)
        self.nu = torch.zeros_like(p)
        bc = np.stack([_bias_corrections(B1, steps),
                       _bias_corrections(B2, steps)], 1)
        self._bc = torch.tensor(bc, device=p.device)
        self._lr = float(np.float32(-lr))
        self._c1 = float(np.float32(1.0 - B1))
        self._c2 = float(np.float32(1.0 - B2))

    @torch.no_grad()
    def step(self, g: torch.Tensor) -> None:
        bc1, bc2 = self._bc[self.t]
        self.t += 1
        self.mu = _fma(g, self._c1, B1 * self.mu)
        self.nu = _fma(g * g, self._c2, B2 * self.nu)
        root = torch.sqrt((self.nu / bc2).to(F64)).to(F32)
        self.p.copy_(_fma(self.mu / (bc1 * (root + EPS)), self._lr, self.p))
