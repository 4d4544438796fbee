"""The port's whole train step against the JAX package's, same weights.

A tiny flax CENet with the flagship switches and every dropout rate 0
(so no random stream has to agree) takes two train steps: the forward
with train=True (BatchNorm on batch statistics, mutable batch_stats), the
'avg'-merged MoE similarity, the max-margin loss (margin 0.05, fix_norm),
value_and_grad, and Adam (lr 5e-5) from ``build_optimizer``, with both
Pallas kernels in interpret mode.  The port's CENet gets the same weights
through ``state_dict_from_flax`` and takes the same two steps through
``train.step.train_step`` (plain versions on the CPU; in train mode the
port's FFN is the train block, JAX's the eval block at rate 0: the same
function in fp32).

fp32 throughout.  Tolerances: the loss 1e-6; every gradient, mapped onto
the port's names with the same ``state_dict_from_flax``, 1e-4 (relative
and absolute: fp32 sum-order noise through two 2-layer towers, as the
eval forward's test); the BatchNorm running statistics 1e-6; the
parameters after two Adam steps 1e-6.  One exception: the ContextGating
biases in front of the train-mode BatchNorm (``cg.fc.bias``) have a zero
gradient in exact arithmetic (the batch mean cancels them), so each
package's gradient is ~1e-9 of rounding noise, which Adam normalises into
an update of up to lr per step; those are held to 2 * lr after two
steps, and the step-2 running means, which take in that bias, are
compared after removing 0.1 x the step-1 bias difference.  Each JAX
gradient is computed once (eager interpret-mode Pallas dominates the run
time).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.ops import ffn as flax_ffn
from mmt_tpu.ops import similarity as flax_similarity
from mmt_tpu.train import losses as flax_losses
from mmt_tpu.train import optim as flax_optim
from mmt_tpu_torch import convert
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.train import losses, optim, step
from tests.conftest import make_batch

LR = 5e-5
PRE_BN_BIAS = "cg.fc.bias"   # zero gradient in exact arithmetic
SPEC = {"type": "Adam", "args": {"lr": LR, "weight_decay": 0}}
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


def _arch(tiny_arch):
  arch = dict(tiny_arch)
  arch["vid_bert_params"] = {**tiny_arch["vid_bert_params"], **NO_DROPOUT}
  arch["txt_bert_params"] = dict(NO_DROPOUT)
  return arch


def _flat(tree):
  """Flax tree -> the port's state-dict names (numpy), BN counters out."""
  params, stats = tree
  sd = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params), stats)
  return {k: v.numpy() for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def jax_run(tiny_arch):
  """Two JAX train steps: the arch, batch and initial variables, and for
  each step its loss, grads, and parameters and batch stats after it."""
  arch = _arch(tiny_arch)
  batch = make_batch(arch["expert_dims"], b=4, k=2, t=7, l=5, seed=3)
  model = FlaxCENet(**arch)
  variables = model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False)
  loss_fn = flax_losses.max_margin_ranking_loss(0.05, True)

  def loss(params, stats):
    out, mut = model.apply({"params": params, "batch_stats": stats}, batch,
                           train=True, rngs={"dropout": jax.random.PRNGKey(2)},
                           mutable=["batch_stats"])
    return loss_fn(flax_sims(out, merge="avg")), mut["batch_stats"]

  tx, _ = flax_optim.build_optimizer(SPEC)
  params, stats = variables["params"], variables["batch_stats"]
  opt_state = tx.init(params)
  steps = []
  flax_ffn.use_pallas(True, interpret=True)
  flax_similarity.use_pallas(True, interpret=True)
  try:
    for _ in range(2):
      (value, new_stats), grads = jax.value_and_grad(loss, has_aux=True)(
          params, stats)
      updates, opt_state = tx.update(grads, opt_state, params)
      params = optax.apply_updates(params, updates)
      steps.append(dict(loss=float(value), grads=_flat((grads, new_stats)),
                        state=_flat((params, new_stats))))
      stats = new_stats
  finally:
    flax_ffn.use_pallas(False)
    flax_similarity.use_pallas(False)
  return arch, batch, variables, steps


@pytest.fixture(scope="module")
def port_run(jax_run):
  """The same two steps in the port: each step's loss, grads, buffers
  and parameters."""
  arch, batch, variables, _ = jax_run
  model = CENet(**arch, device="cpu").train()
  model.load_state_dict(convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"]),
      variables["batch_stats"]), strict=True)
  opt, lr = optim.build_optimizer(SPEC, model.parameters())
  tb = batch_to_torch(batch, "cpu")
  gen = torch.Generator().manual_seed(0)
  steps = []
  for _ in range(2):
    value = step.train_step(model, opt, tb, generator=gen, lr=lr,
                            loss_fn=losses.max_margin_ranking_loss(0.05,
                                                                   True))
    steps.append(dict(
        loss=float(value),
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
        state={n: t.detach().numpy().copy()
               for n, t in model.state_dict().items()}))
  return steps


@pytest.mark.parametrize("i", [0, 1])
def test_step_loss_matches_jax(jax_run, port_run, i):
  want = jax_run[3][i]["loss"]
  assert abs(port_run[i]["loss"] - want) <= 1e-6, (port_run[i]["loss"], want)


@pytest.mark.parametrize("i", [0, 1])
def test_step_gradients_match_jax(jax_run, port_run, i):
  want = jax_run[3][i]["grads"]
  got = port_run[i]["grads"]
  grads = {k: v for k, v in want.items() if not k.endswith("running_mean")
           and not k.endswith("running_var")}
  assert set(grads) == set(got)
  for name, w in grads.items():
    np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize("i", [0, 1])
def test_step_batchnorm_stats_match_jax(jax_run, port_run, i):
  want, got = jax_run[3][i]["state"], port_run[i]["state"]
  names = [k for k in want if k.endswith(("running_mean", "running_var"))]
  assert names
  for name in names:
    expect = want[name]
    if i == 1 and name.endswith("running_mean"):
      # The gate's batch mean includes cg.fc.bias, whose step-1 values
      # differ by Adam-normalised noise (see the module docstring).
      bias = name.replace("batch_norm.running_mean", "fc.bias")
      expect = expect + 0.1 * (port_run[0]["state"][bias]
                               - jax_run[3][0]["state"][bias])
    np.testing.assert_allclose(got[name], expect, rtol=0, atol=1e-6,
                               err_msg=name)
  assert all(int(got[n.replace("running_mean", "num_batches_tracked")])
             == i + 1 for n in names if n.endswith("running_mean"))


def test_params_after_two_adam_steps_match_optax(jax_run, port_run):
  want, got = jax_run[3][1]["state"], port_run[1]["state"]
  for name, w in want.items():
    if name.endswith("running_mean") or name.endswith("running_var"):
      continue  # held by test_step_batchnorm_stats_match_jax
    atol = 2 * LR if name.endswith(PRE_BN_BIAS) else 1e-6
    np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                               err_msg=name)
