"""Rank functions of tests/test_torch_tensor_parallel.py.

``parallel.spawn`` runs them in new processes, which import them by
module path, so they live in this module, which imports no JAX.  Inputs
come in as numpy arrays, results go back as numpy arrays and Python
values.  Everything runs on the CPU in fp32 (the plain versions).
"""

import numpy as np
import torch

from mmt_tpu_torch import convert, flagship
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ffn
from mmt_tpu_torch.parallel import mesh as tp_lib
from mmt_tpu_torch.train import losses, optim, step

SPEC = {"type": "Adam", "args": {"lr": 5e-5, "weight_decay": 0}}


def _t(a):
  return torch.from_numpy(np.array(a))


def _np(tensors):
  return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def collectives(tp):
  """Megatron's f and g on x = rank + 1: g's value is the sum and its
  gradient the identity; f's gradient is the sum of the ranks'."""
  x = torch.full((3,), float(tp.rank + 1), requires_grad=True)
  y = tp_lib.reduce_from_tp(x * 1.0, tp)
  y.sum().backward()
  g_value, g_grad = y.detach().numpy(), x.grad.numpy().copy()
  x.grad = None
  (tp_lib.copy_to_tp(x, tp) * float(tp.rank + 1)).sum().backward()
  return {"g_value": g_value, "g_grad": g_grad, "f_grad": x.grad.numpy()}


def ffn_blocks(tp, args, drop):
  """The TP eval block's output and the TP train block's gradients of
  sum(out ** 2), gathered, from JAX-layout numpy args (x, w1 [H, I], b1,
  w2 [I, H], b2, gamma, beta) cut to this rank's shards."""
  x, w1, b1, w2, b2, gamma, beta = (_t(a) for a in args)
  dims = {"w1": 0, "b1": 0, "w2": 1}
  local = convert.shard_state_dict({"w1": w1.T, "b1": b1, "w2": w2.T}, tp,
                                   dims)
  kw = dict(eps=1e-12, compute_dtype=torch.float32, tp=tp)
  with torch.inference_mode():
    evald = ffn.ffn_block_tp(x, local["w1"], local["b1"], local["w2"], b2,
                             gamma, beta, **kw)
  params = {"x": x, **local, "b2": b2, "gamma": gamma, "beta": beta}
  for p in params.values():
    p.requires_grad_()
  out = ffn.ffn_block_train(params["x"], _t(drop), params["w1"],
                            params["b1"], params["w2"], b2, gamma, beta, **kw)
  (out ** 2).sum().backward()
  grads = convert.gather_state_dict({k: p.grad for k, p in params.items()},
                                    tp, dims)
  return {"eval": evald.numpy(), "grads": _np(grads)}


def _model(tp, arch, state_dict):
  model = CENet(**arch, device="cpu", tp=tp)
  full = {k: _t(v) for k, v in state_dict.items()}
  model.load_state_dict(convert.shard_state_dict(full, tp, model.shard_dims),
                        strict=True)
  return model


def _step(model, opt, batch, seed):
  loss = step.train_step(model, opt, batch, generator=torch.Generator()
                         .manual_seed(seed), lr=SPEC["args"]["lr"],
                         loss_fn=losses.max_margin_ranking_loss(0.05, True))
  return float(loss)


def cenet(tp, arch, state_dict, batch, dropout_arch):
  """The tiny CENet on this rank's shards: the eval outputs; one train
  step's loss and gathered gradients; the replicated parameters after a
  second step; and, with ``dropout_arch``'s rates, one step's loss and
  gathered gradients (generator seed 5)."""
  tb = flagship.batch_to_torch(batch, "cpu")
  model = _model(tp, arch, state_dict)
  with torch.inference_mode():
    outputs = _np(model.eval()(tb))
  opt, _ = optim.build_optimizer(SPEC, model.train().parameters())
  loss = _step(model, opt, tb, 0)
  grads = convert.gather_state_dict(
      {n: p.grad for n, p in model.named_parameters()}, tp, model.shard_dims)
  _step(model, opt, tb, 1)
  replicated = {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()
                if n not in model.shard_dims}

  model = _model(tp, dropout_arch, state_dict)
  opt, _ = optim.build_optimizer(SPEC, model.train().parameters())
  drop_loss = _step(model, opt, tb, 5)
  drop_grads = convert.gather_state_dict(
      {n: p.grad for n, p in model.named_parameters()}, tp, model.shard_dims)
  return {"outputs": outputs, "loss": loss, "grads": _np(grads),
          "replicated": replicated, "dropout_loss": drop_loss,
          "dropout_grads": _np(drop_grads)}


def flagship_split(tp, batch):
  """The tiny flagship made with ``tp``: its gathered state dict and its
  eval outputs on ``batch``."""
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, tp=tp)
  with torch.inference_mode():
    outputs = _np(model(flagship.batch_to_torch(batch, "cpu")))
  return {"state": _np(convert.gather_state_dict(model.state_dict(), tp,
                                                 model.shard_dims)),
          "outputs": outputs}


def all_checks(tp, ffn_inputs, cenet_inputs, flagship_batch):
  """Every rank-side check of the test module, in one group."""
  torch.set_num_threads(1)
  return {"collectives": collectives(tp),
          "ffn": ffn_blocks(tp, *ffn_inputs),
          "cenet": cenet(tp, **cenet_inputs),
          "flagship": flagship_split(tp, flagship_batch)}


def fail_on_rank_one(tp):
  """Rank 1 raises; rank 0 waits at a barrier it never passes alone."""
  if tp.rank == 1:
    raise ValueError("rank one fails on purpose")
  torch.distributed.barrier()


def hang_on_rank_one(tp):
  """Rank 1 never reaches the collective; rank 0 waits at it."""
  if tp.rank == 1:
    import time
    time.sleep(600)
  torch.distributed.barrier()
