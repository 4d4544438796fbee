"""Optimizers and schedules on torch.optim.

Port of mmt_tpu/train/optim.py: ``step_lr`` (torch StepLR per epoch),
``linear_warmup`` (pytorch_warmup's linear dampening) and
``build_optimizer`` for the ``{"type", "args"}`` config entry.  The JAX
package's ``Adam`` with a nonzero weight decay is optax.adamw, whose decay
is decoupled, so it maps to ``torch.optim.AdamW`` (``torch.optim.Adam``'s
weight_decay adds to the gradient instead).  Ranger and the bertfrz
freeze masks are not ported yet.
"""

from __future__ import annotations

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


_OPTIMIZERS = {"Adam": _adam, "AdamW": _adamw, "SGD": _sgd}


def build_optimizer(spec, params):
  """{'type', 'args'} config entry and the parameters to train ->
  (torch.optim optimizer, base_lr).  The caller sets each step's rate on
  the param groups (``train.step.train_step``)."""
  kind = spec["type"]
  if kind not in _OPTIMIZERS:
    raise NotImplementedError(
        f"optimizer {kind!r}: the port has {sorted(_OPTIMIZERS)}")
  args = dict(spec.get("args", {}))
  opt = _OPTIMIZERS[kind](params, **args)
  return opt, args["lr"]
