"""Rank functions of tests/test_torch_model_parallel.py.

``parallel.spawn`` runs them in new processes, which import them by
module path, so they live in this module, which imports no JAX.  Inputs
come in as numpy arrays, results go back as numpy arrays and Python
values.  Everything runs on the CPU in fp32 (the plain versions), one
thread a rank.  ``step`` is also the single-process reference the test
module runs itself.
"""

import numpy as np
import torch

from mmt_tpu_torch import cli, convert, flagship
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.train import checkpoint as ckpt_lib
from mmt_tpu_torch.train import losses, optim
from mmt_tpu_torch.train.step import train_step

SPEC = {"type": "Adam", "args": {"lr": 5e-5, "weight_decay": 0}}
OUTPUTS = ("text_embds", "text_weights", "vid_embds", "vid_weights")


def _np(named):
  return {n: t.detach().cpu().numpy().copy() for n, t in named}


def step(arch, state_dict, batch, seed, dp=None, tp=None, freeze=None,
         wrong_sum=False, spec=SPEC):
  """One Adam step (``train_step``) of the CENet ``arch`` from the whole
  ``state_dict`` on the global ``batch``: this rank's rows of it with a
  data group ``dp``, its shards with a model group ``tp``, ``freeze`` =
  (txt_agg, txt_inp) for ``cli.freeze_parameters``, dropout from
  generator seed ``seed``.  Returns the loss; this rank's rows of the
  train forward's outputs; the gradients (the model group's shards
  gathered; None for a frozen parameter); the BatchNorm running
  buffers; the optimizer's state after the step, in the single-process
  layout (``spec`` names the optimizer).  ``wrong_sum``: also the
  gradients after a further sum over the model group (the fault the
  data-only sum avoids)."""
  model = CENet(**arch, device="cpu", tp=tp).train()
  full = {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}
  model.load_state_dict(full if tp is None else convert.shard_state_dict(
      full, tp, model.shard_dims), strict=True)
  if freeze is not None:
    cli.freeze_parameters(model, *freeze)
  opt = optim.build_optimizer(
      spec, [p for p in model.parameters() if p.requires_grad])[0]
  rows = batch if dp is None else mesh_lib.local_rows(batch, dp)
  seen = {}
  model.register_forward_hook(lambda mod, args, out: seen.update(out))
  loss = train_step(model, opt, flagship.batch_to_torch(rows, "cpu"),
                    lr=spec["args"]["lr"], dp=dp,
                    generator=torch.Generator().manual_seed(seed),
                    loss_fn=losses.max_margin_ranking_loss(0.05, True))
  grads = {n: p.grad for n, p in model.named_parameters()}
  gather = ((lambda g: g) if tp is None else
            lambda g: convert.gather_state_dict(g, tp, model.shard_dims))
  out = {"loss": float(loss),
         "outputs": _np((k, seen[k]) for k in OUTPUTS),
         "grads": {n: None if g is None else g.numpy().copy()
                   for n, g in gather(grads).items()},
         "buffers": _np((n, b) for n, b in model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))),
         "shard_dims": dict(model.shard_dims)}
  state = opt.state_dict()
  if tp is not None:
    names = ckpt_lib.param_names_by_position(model, opt)
    state = convert.gather_optimizer_state(state, names, tp,
                                           model.shard_dims)
    local = convert.shard_optimizer_state(state, names, tp, model.shard_dims)
    out["reshard_equal"] = all(
        torch.equal(local["state"][i][k], v)
        for i, entry in opt.state_dict()["state"].items()
        for k, v in entry.items())
  out["optimizer"] = {i: {k: v.numpy().copy() for k, v in entry.items()}
                      for i, entry in state["state"].items()}
  if wrong_sum:
    mesh_lib.all_reduce_grads(model.parameters(), tp)
    out["wrong_grads"] = {n: g.numpy().copy() for n, g in gather(
        {n: p.grad for n, p in model.named_parameters()}).items()}
  return out


def layout(group):
  """This rank's place in ``data_mesh(group, M)`` for M = 1, 2, 4: (data
  rank, data size, model rank, model size), an axis of size 1 as (0, 1),
  and the sum of the global ranks over each group (which ranks it
  holds); a world M = 3 does not divide raises."""
  out = {}
  for mp in (1, 2, 4):
    data, model = mesh_lib.data_mesh(group, mp)
    place, sums = [], []
    for g in (data, model):
      place += [0, 1] if g is None else [g.rank, g.size]
      sums.append(group.rank if g is None else
                  float(g.all_reduce(torch.tensor([float(group.rank)]))[0]))
    out[mp] = {"place": place, "sums": sums}
  try:
    mesh_lib.data_mesh(group, 3)
  except ValueError as exc:
    out["mp3"] = str(exc)
  return out


def hosts(group):
  """``data_mesh(group, 2)`` with the ranks' hostnames patched: ranks on
  hosts by r // 2 (each model group on one host) lay out; by r % 2 (the
  model group {0, 1} across two hosts) raise."""
  real = mesh_lib.socket.gethostname
  out = {}
  try:
    for name, host in (("by_pairs", group.rank // 2),
                       ("by_parity", group.rank % 2)):
      mesh_lib.socket.gethostname = lambda host=host: f"host{host}"
      try:
        data, model = mesh_lib.data_mesh(group, 2)
        out[name] = (data.size, model.size)
      except ValueError as exc:
        out[name] = str(exc)
  finally:
    mesh_lib.socket.gethostname = real
  return out


def one_by_two(group, step_case, switch_cases):
  """The 1 x 2 layout (two model ranks, no data axis): the step of
  ``step_case`` (arch, state_dict, batch, seed) and of each switch case
  (the same, then freeze and the optimizer's spec)."""
  torch.set_num_threads(1)
  data, tp = mesh_lib.data_mesh(group, 2)
  assert data is None and tp.size == 2
  out = {"step": step(*step_case, tp=tp)}
  for name, (arch, sd, batch, seed, freeze, spec) in switch_cases.items():
    out[name] = step(arch, sd, batch, seed, tp=tp, freeze=freeze, spec=spec)
  return out


def two_by_two(group, cases):
  """Four ranks: the layout and host checks, then the 2 x 2 step of each
  case (arch, state_dict, batch, seed), the first also with the wrong
  gradient sum."""
  torch.set_num_threads(1)
  out = {"layout": layout(group), "hosts": hosts(group)}
  data, tp = mesh_lib.data_mesh(group, 2)
  for i, (name, case) in enumerate(cases.items()):
    out[name] = step(*case, dp=data, tp=tp, wrong_sum=i == 0)
  out["rows"] = [data.rank, data.size]
  return out
