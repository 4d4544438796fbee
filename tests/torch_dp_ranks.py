"""Rank functions of tests/test_torch_data_parallel.py.

``parallel.spawn`` runs them in new processes, which import them by
module path, so they live in this module, which imports no JAX.  Inputs
come in as numpy arrays, results go back as numpy arrays and Python
values.  Everything runs on the CPU in fp32 (the plain versions), one
thread a rank.
"""

import numpy as np
import torch

from mmt_tpu_torch import flagship
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.train import losses, metrics, optim, step

SPEC = {"type": "Adam", "args": {"lr": 5e-5, "weight_decay": 0}}
STEPS = 3


def data_parallel(group):
  """The spawned group, one thread a rank."""
  torch.set_num_threads(1)
  return group


def model_from(arch, state_dict):
  model = CENet(**arch, device="cpu").train()
  model.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in state_dict.items()}, strict=True)
  return model


def _np(named):
  return {n: t.detach().cpu().numpy().copy() for n, t in named}


def buffers(model):
  """The BatchNorm running statistics."""
  return _np((n, b) for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var")))


def steps(arch, state_dict, batch, seed, dp=None):
  """``STEPS`` Adam steps from ``state_dict`` on ``batch`` (this rank's
  rows of it with ``dp``), the first from generator seed ``seed``: the
  first step's loss, gradients and BatchNorm buffers, and every parameter
  and buffer after the last step."""
  model = model_from(arch, state_dict)
  opt = optim.build_optimizer(SPEC, model.parameters())[0]
  rows = batch if dp is None else mesh_lib.local_rows(batch, dp)
  tb = flagship.batch_to_torch(rows, "cpu")
  out = {}
  for i in range(STEPS):
    loss = step.train_step(
        model, opt, tb, lr=SPEC["args"]["lr"], dp=dp,
        generator=torch.Generator().manual_seed(seed + i),
        loss_fn=losses.max_margin_ranking_loss(0.05, True))
    if i == 0:
      out["loss"] = float(loss)
      out["grads"] = _np((n, p.grad) for n, p in model.named_parameters())
      out["buffers"] = buffers(model)
  out["state"] = _np(list(model.named_parameters())
                     + list(model.named_buffers()))
  return out


def collectives(dp):
  """gather_rows and all_reduce_sum on x = rank + 1 (two rows a rank):
  the values, and the gradients of sum(w * gathered) and of
  sum(w * reduced) with w = 1 + the gathered row index."""
  x = torch.full((2, 3), float(dp.rank + 1), requires_grad=True)
  g = mesh_lib.gather_rows(x * 1.0, dp)
  w = torch.arange(1.0, 1.0 + g.shape[0])[:, None]
  (w * g).sum().backward()
  gathered, gather_grad = g.detach().numpy(), x.grad.numpy().copy()
  x.grad = None
  r = mesh_lib.all_reduce_sum(x * 1.0, dp)
  (r * float(dp.rank + 1)).sum().backward()
  return {"gathered": gathered, "gather_grad": gather_grad,
          "reduced": r.detach().numpy(), "reduce_grad": x.grad.numpy()}


def fused(dp, inputs):
  """fused_retrieval_metrics with the candidates split over the group."""
  te, ve, tw, vw, masks = inputs
  return metrics.fused_retrieval_metrics(te, ve, tw, vw, masks,
                                         device="cpu", dp=dp)


def all_checks(tp, cases, fused_inputs):
  """Every rank-side check of one group: ``cases`` maps a name to (arch,
  state_dict, global batch, seed) for ``steps``; plus the collectives and
  the sharded fused metrics."""
  dp = data_parallel(tp)
  out = {name: steps(*case, dp=dp) for name, case in cases.items()}
  out["collectives"] = collectives(dp)
  out["fused"] = fused(dp, fused_inputs)
  return out


def fused_only(tp, fused_inputs):
  return fused(data_parallel(tp), fused_inputs)

