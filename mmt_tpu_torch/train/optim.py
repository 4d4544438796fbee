"""Optimizers and schedules on torch.optim.

Port of mmt_tpu/train/optim.py: ``step_lr`` (torch StepLR per epoch),
``linear_warmup`` (pytorch_warmup's linear dampening), ``Ranger`` (RAdam +
Lookahead) and ``build_optimizer`` for the ``{"type", "args"}`` config
entry.  The JAX package's ``Adam`` with a nonzero weight decay is
optax.adamw, whose decay is decoupled, so it maps to ``torch.optim.AdamW``
(``torch.optim.Adam``'s weight_decay adds to the gradient instead).

The bertfrz freeze masks (the JAX package's ``optax.masked(set_to_zero)``
after the optimizer) are parameters left out of the optimizer with
``requires_grad=False`` (cli.py:freeze_parameters): their update is zero,
decoupled decay included.
"""

from __future__ import annotations

import numpy as np
import torch


def step_lr(base_lr: float, step_size: int = 1, gamma: float = 1.0):
  """lr(epoch) = base * gamma^(epoch // step_size)."""
  def schedule(epoch: int) -> float:
    return base_lr * (gamma ** (epoch // step_size))
  return schedule


def linear_warmup(warmup_period: int):
  """Dampening factor(step) = min(1, (step + 1) / period)."""
  def factor(step: int) -> float:
    if warmup_period <= 0:
      return 1.0
    return min(1.0, (step + 1) / warmup_period)
  return factor


def _adam(params, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8):
  if weight_decay:
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)
  return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def _adamw(params, lr, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8):
  return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                           weight_decay=weight_decay)


def _sgd(params, lr, momentum=0.0, weight_decay=0.0):
  return torch.optim.SGD(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay)


class Ranger(torch.optim.Optimizer):
  """RAdam with an integrated lookahead (mmt_tpu/train/optim.py:ranger_lr,
  the reference's utils/ranger.py:107-195).

  Per step t of a parameter p with gradient g:

  * m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2;
  * the variance's SMA n_sma = n_max - 2 t b2^t / (1 - b2^t),
    n_max = 2 / (1 - b2) - 1.  Above ``n_sma_threshhold`` the step is
    the rectified Adam one, rect / (1 - b1^t) * m / (sqrt(v) + eps);
    at or below it the momentum-SGD one, m / (1 - b1^t);
  * decoupled weight decay scaled by lr: fast = p - wd lr p - lr step;
  * every k-th step the lookahead: slow += alpha (fast - slow), and p
    takes slow; otherwise p takes fast.

  lr scales the step before the lookahead blend, in the JAX package's
  order, and the parameter moves by the delta, as optax applies it.  The state of each parameter is ``step``, ``exp_avg`` (m),
  ``exp_avg_sq`` (v) and ``slow_buffer``; a parameter without a gradient
  is skipped.
  """

  def __init__(self, params, lr=1e-3, alpha=0.5, k=6, n_sma_threshhold=5,
               betas=(0.95, 0.999), eps=1e-5, weight_decay=0.0):
    super().__init__(params, dict(
        lr=lr, alpha=alpha, k=int(k), n_sma_threshhold=n_sma_threshhold,
        betas=tuple(betas), eps=eps, weight_decay=weight_decay))

  @staticmethod
  def step_size(count, b1, b2, threshold):
    """(the step's scale, whether the rectified Adam step applies) at step
    ``count``, in float32 as the JAX package computes it: near the
    threshold n_sma is the difference of two numbers near 2 / (1 - b2),
    and float64 would move step 6's scale by 0.2% (b2 0.999)."""
    f32 = np.float32
    # b^t of the float32 b, rounded once to float32 (XLA's pow gives the
    # same; numpy's float32 pow is an ulp off at some t, which moves n_sma
    # by 0.15%).
    power = lambda b: f32(np.float64(f32(b)) ** count)
    cnt = f32(count)
    beta2_t = power(b2)
    n_max = f32(2.0 / (1.0 - b2) - 1.0)
    n_sma = n_max - f32(2.0) * cnt * beta2_t / (f32(1.0) - beta2_t)
    bias1 = f32(1.0) - power(b1)
    if not n_sma > threshold:
      return float(f32(1.0) / bias1), False
    rect = np.sqrt((f32(1.0) - beta2_t) * (n_sma - f32(4.0))
                   / (n_max - f32(4.0)) * (n_sma - f32(2.0)) / n_sma * n_max
                   / (n_max - f32(2.0)))
    return float(rect / bias1), True

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      lr, (b1, b2), wd = group["lr"], group["betas"], group["weight_decay"]
      for p in group["params"]:
        if p.grad is None:
          continue
        g = p.grad
        state = self.state[p]
        if not state:
          # On the host, as torch's Adam keeps it: no device sync a step.
          state["step"] = torch.tensor(0.0)
          state["exp_avg"] = torch.zeros_like(p)
          state["exp_avg_sq"] = torch.zeros_like(p)
          state["slow_buffer"] = p.detach().clone()
        state["step"] += 1
        count = int(state["step"].item())
        m, v = state["exp_avg"], state["exp_avg_sq"]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        scale, adaptive = self.step_size(count, b1, b2,
                                         group["n_sma_threshhold"])
        d = m / (v.sqrt() + group["eps"]) if adaptive else m
        fast = p - (wd * lr) * p if wd else p.clone()
        fast.sub_(d, alpha=scale * lr)
        if count % group["k"] == 0:
          slow = state["slow_buffer"]
          slow.add_(fast - slow, alpha=group["alpha"])
          fast = slow
        # p + (new - p), not new: the JAX package returns the delta as its
        # update and optax adds it, and so the roundings agree.
        p.add_(fast - p)
    return loss


_OPTIMIZERS = {"Adam": _adam, "AdamW": _adamw, "SGD": _sgd,
               "Ranger": Ranger}


def build_optimizer(spec, params):
  """{'type', 'args'} config entry and the parameters to train ->
  (torch.optim optimizer, base_lr).  The caller sets each step's rate on
  the param groups (``train.step.train_step``)."""
  kind = spec["type"]
  if kind not in _OPTIMIZERS:
    raise KeyError(f"unknown optimizer {kind!r}; registered: "
                   f"{sorted(_OPTIMIZERS)}")
  opt = _OPTIMIZERS[kind](params, **dict(spec.get("args", {})))
  return opt, opt.defaults["lr"]
