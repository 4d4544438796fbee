"""Ranger, the bertfrz freeze masks and the JAX checkpoints of such runs.

* The port's ``Ranger`` against ``mmt_tpu.train.optim.ranger_lr`` (through
  the JAX ``build_optimizer``'s injected learning rate, changed every step
  as the trainer does) over 13 steps with k = 6 and weight decay: the
  momentum-SGD steps 1-5, the rectified steps from 6 on, the lookahead at
  steps 6 and 12; parameters at 1e-6 relative, and the moments and slow
  buffer at the end.
* The port's freeze masks against train.py:frozen_param_mask, by name.
  Frozen parameters stay bitwise unmoved under AdamW with decay; under
  ``bertfrz4`` with ``bertftn`` input the embeddings below the frozen
  layers still get a gradient, and every trainable gradient equals the
  unfrozen model's bitwise (the FFN block skips only the frozen weights'
  GEMMs).
* A JAX checkpoint of a frozen Adam run and of a frozen Ranger run read
  with their moments (and slow buffer), the frozen leaves' dropped.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.train import optim as jax_optim
from mmt_tpu_torch import cli, convert
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ffn
from mmt_tpu_torch.train import checkpoint as ckpt_lib
from mmt_tpu_torch.train import losses, optim
from mmt_tpu_torch.train.step import train_step
from tests.conftest import make_batch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import train as jax_cli  # noqa: E402

RANGER = {"type": "Ranger", "args": {"lr": 1e-2, "k": 6,
                                     "weight_decay": 0.05}}
STEPS = 13


def ranger_runs(spec=RANGER, steps=STEPS):
  """(flax params, opt_state) and the port's parameters and Ranger after
  ``steps`` updates with the same seeded gradients and per-step rates."""
  rng = np.random.RandomState(0)
  params = {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
  tx, base_lr = jax_optim.build_optimizer(spec)
  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  state = tx.init(jparams)
  tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params.items()}
  opt, lr0 = optim.build_optimizer(spec, list(tparams.values()))
  assert lr0 == base_lr
  history = []
  for step in range(steps):
    lr = base_lr * (0.5 + 0.1 * step)
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    state.hyperparams["learning_rate"] = jnp.asarray(lr)
    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    for group in opt.param_groups:
      group["lr"] = lr
    for k, p in tparams.items():
      p.grad = torch.from_numpy(grads[k])
    opt.step()
    history.append(({k: np.asarray(v) for k, v in jparams.items()},
                    {k: p.detach().numpy().copy() for k, p in tparams.items()}))
  return state, tparams, opt, history


def test_ranger_matches_jax():
  state, tparams, opt, history = ranger_runs()
  for step, (want, got) in enumerate(history, 1):
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                 err_msg=f"step {step} {k}")
  # Both sides of the n_sma threshold, and two lookahead steps.
  adaptive = [optim.Ranger.step_size(t, 0.95, 0.999, 5)[1]
              for t in range(1, STEPS + 1)]
  assert adaptive == [False] * 5 + [True] * (STEPS - 5)
  assert [t for t in range(1, STEPS + 1) if t % 6 == 0] == [6, 12]
  moments = state.inner_state
  for k, p in tparams.items():
    entry = opt.state[p]
    assert int(entry["step"]) == int(moments.count) == STEPS
    for key, tree in (("exp_avg", moments.mu), ("exp_avg_sq", moments.nu),
                      ("slow_buffer", moments.slow)):
      np.testing.assert_allclose(entry[key].numpy(), np.asarray(tree[k]),
                                 rtol=1e-6, atol=1e-9, err_msg=f"{key} {k}")


def test_ranger_state_round_trips_a_checkpoint(tmp_path):
  """Ranger's state (step, moments, slow buffer) goes through a .pth and
  resumes to the same next step."""
  _, tparams, opt, _ = ranger_runs(steps=7)
  path = ckpt_lib.save_checkpoint(
      tmp_path, ckpt_lib.to_host({"optimizer": opt.state_dict()}), 1)
  params2 = [torch.nn.Parameter(p.detach().clone())
             for p in tparams.values()]
  opt2, _ = optim.build_optimizer(RANGER, params2)
  opt2.load_state_dict(ckpt_lib.load_checkpoint(path)["optimizer"])
  for p, q in zip(tparams.values(), params2):
    g = torch.full_like(p, 0.3)
    p.grad, q.grad = g, g.clone()
  opt.step()
  opt2.step()
  for p, q in zip(tparams.values(), params2):
    assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# Freeze masks
# ---------------------------------------------------------------------------

FREEZE_CASES = [("bertfrz", "bertftn"), ("bertfrz4", "bertftn"),
                ("bertftn", "bertfrz"), ("bertftn", "bertftn"),
                ("vlad", "wo2vfrz")]


def freeze_arch(tiny_arch, txt_agg, txt_inp):
  arch = dict(tiny_arch, txt_agg=txt_agg, txt_inp=txt_inp,
              text_bert_geometry=dict(tiny_arch["text_bert_geometry"],
                                      num_hidden_layers=5),
              vid_bert_params=dict(tiny_arch["vid_bert_params"],
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0),
              txt_bert_params=dict(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0))
  if txt_agg == "vlad":
    arch.update(we_vocab_size=100, we_dim=16)
  return arch


@pytest.mark.parametrize("txt_agg,txt_inp", FREEZE_CASES)
def test_frozen_names_match_jax_mask(tiny_arch, txt_agg, txt_inp):
  arch = freeze_arch(tiny_arch, txt_agg, txt_inp)
  batch = make_batch(arch["expert_dims"], b=2, k=1, t=5, l=3)
  params = FlaxCENet(**arch).init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch)["params"]
  mask = jax_cli.frozen_param_mask(params, txt_agg, txt_inp)
  want = set()
  if mask is not None:
    for path, frozen in jax.tree_util.tree_flatten_with_path(mask)[0]:
      if frozen:
        want.add(convert._param_name("/".join(k.key for k in path))[0])
  model = CENet(**arch, device="cpu")
  got = cli.freeze_parameters(model, txt_agg, txt_inp)
  assert set(got) == want
  assert (len(want) > 0) == ((txt_agg, txt_inp) != ("bertftn", "bertftn"))
  assert {n for n, p in model.named_parameters()
          if not p.requires_grad and "bias_ih" not in n} == want


def step_model(tiny_arch, txt_agg, txt_inp, freeze, opt_spec, steps=3):
  """A port model trained ``steps`` AdamW steps (decay 0.1) on one tiny
  batch; returns (model, initial state dict, first step's grads)."""
  arch = freeze_arch(tiny_arch, txt_agg, txt_inp)
  model = CENet(**arch, device="cpu").init_weights(
      torch.Generator().manual_seed(0)).train()
  if freeze:
    cli.freeze_parameters(model, txt_agg, txt_inp)
  init = {k: v.clone() for k, v in model.state_dict().items()}
  opt, _ = optim.build_optimizer(
      opt_spec, [p for p in model.parameters() if p.requires_grad])
  batch = batch_to_torch(make_batch(arch["expert_dims"], b=4, k=1, t=6,
                                    l=3), "cpu")
  gen = torch.Generator().manual_seed(1)
  loss_fn = losses.max_margin_ranking_loss(0.1, True)
  grads = None
  for _ in range(steps):
    train_step(model, opt, batch, loss_fn=loss_fn, lr=1e-2, generator=gen)
    if grads is None:
      grads = {n: None if p.grad is None else p.grad.clone()
               for n, p in model.named_parameters()}
  return model, init, grads


ADAMW = {"type": "AdamW", "args": {"lr": 1e-2, "weight_decay": 0.1}}


@pytest.mark.parametrize("txt_agg,txt_inp", [("bertfrz4", "bertftn"),
                                             ("bertftn", "bertfrz")])
def test_frozen_parameters_do_not_move(tiny_arch, txt_agg, txt_inp):
  model, init, grads = step_model(tiny_arch, txt_agg, txt_inp, True, ADAMW)
  frozen = {n for n, p in model.named_parameters()
            if not p.requires_grad and "bias_ih" not in n}
  assert frozen
  for name, p in model.named_parameters():
    if name in frozen:
      assert torch.equal(p, init[name]), name
      assert grads[name] is None and p.grad is None, name
  assert not torch.equal(model.vid_bert.encoder.layer[0].output.dense.weight,
                         init["vid_bert.encoder.layer.0.output.dense.weight"])
  if txt_agg == "bertfrz4":
    # Gradients flow through the frozen layers 0-3 to the embeddings.
    emb = grads["txt_bert.embeddings.word_embeddings.weight"]
    assert emb is not None and emb.abs().sum() > 0
    top = model.txt_bert.encoder.layer[4].output.dense.weight
    assert not torch.equal(
        top, init["txt_bert.encoder.layer.4.output.dense.weight"])


def test_frozen_layers_leave_the_trainable_gradients_unchanged(tiny_arch):
  """bertfrz4: every trainable parameter's first gradient equals the
  unfrozen model's bitwise, though the frozen FFN blocks compute no weight
  gradient (their dx still flows)."""
  calls = []
  real = ffn.ffn_train_weight_grads

  def counted(*args, need=(True,) * 6, **kwargs):
    calls.append(tuple(need))
    return real(*args, need=need, **kwargs)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(ffn, "ffn_train_weight_grads", counted)
    _, _, frozen = step_model(tiny_arch, "bertfrz4", "bertftn", True, ADAMW,
                              steps=1)
    n_frozen = sum(1 for need in calls if not any(need))
    _, _, free = step_model(tiny_arch, "bertfrz4", "bertftn", False, ADAMW,
                            steps=1)
  assert n_frozen == 4
  for name, g in frozen.items():
    if g is not None:
      assert torch.equal(g, free[name]), name
  assert sum(g is None for g in frozen.values()) > 0


def test_frozen_layers_train_in_bf16_after_an_eval(tiny_arch):
  """A frozen layer's bf16 weights, cast once under inference_mode (the
  epoch-0 eval), are saved for backward by the next train step: the cast
  copy must be a normal tensor (it once was an inference tensor, which
  autograd refuses)."""
  arch = freeze_arch(tiny_arch, "bertfrz4", "bertftn")
  model = CENet(**arch, device="cpu", compute_dtype=torch.bfloat16)
  model.init_weights(torch.Generator().manual_seed(0))
  cli.freeze_parameters(model, "bertfrz4", "bertftn")
  batch = batch_to_torch(make_batch(arch["expert_dims"], b=4, k=1, t=6,
                                    l=3), "cpu")
  with torch.inference_mode():
    model.eval()(batch)
  opt, _ = optim.build_optimizer(
      RANGER, [p for p in model.parameters() if p.requires_grad])
  loss = train_step(model.train(), opt, batch,
                    loss_fn=losses.max_margin_ranking_loss(0.1, True),
                    lr=1e-3, generator=torch.Generator().manual_seed(1))
  assert torch.isfinite(loss)
  assert model.txt_bert.encoder.layer[0].attention.self.query.weight.grad \
      is None


# ---------------------------------------------------------------------------
# JAX checkpoints of frozen Adam and Ranger runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("Adam", "Ranger"))
def test_jax_checkpoint_of_a_frozen_run_is_read(tiny_arch, tmp_path, kind):
  """Two masked updates by the JAX package's optimizer (bertfrz4), saved
  as its trainer saves a checkpoint (.msgpack): the port reads the
  moments (and Ranger's slow buffer) of every leaf, and puts those of the
  trainable ones into its optimizer, dropping the frozen ones'."""
  from flax import serialization
  arch = freeze_arch(tiny_arch, "bertfrz4", "bertftn")
  batch = make_batch(arch["expert_dims"], b=2, k=1, t=5, l=3)
  variables = FlaxCENet(**arch).init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch)
  params = variables["params"]
  spec = {"type": kind, "args": {"lr": 1e-3}}
  mask = jax_cli.frozen_param_mask(params, "bertfrz4", "bertftn")
  tx, _ = jax_optim.build_optimizer(spec, frozen_mask=mask)
  state = tx.init(params)
  rng = np.random.RandomState(0)
  for _ in range(2):
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  raw = {"params": to_np(params), "batch_stats": to_np(variables[
      "batch_stats"]), "opt_state": to_np(state), "epoch": 1, "n_steps": 2,
         "config": "{}"}
  path = tmp_path / "checkpoint-epoch1.msgpack"
  path.write_bytes(serialization.to_bytes(raw))

  loaded = ckpt_lib.load_checkpoint(path)
  moments = convert._moment_state(serialization.to_state_dict(state))
  fields = ("mu", "nu", "slow") if kind == "Ranger" else ("mu", "nu")
  assert set(fields) <= set(moments)
  for field in fields:
    want = convert._by_port_name(
        jax.tree_util.tree_map(np.asarray, moments[field]), field,
        ih_bias=False)
    key = convert._MOMENTS[field]
    for name, value in want.items():
      assert torch.equal(loaded["optimizer"]["state"][name][key], value)
  assert all(float(e["step"]) == 2
             for e in loaded["optimizer"]["state"].values())

  model = CENet(**arch, device="cpu")
  model.load_state_dict(loaded["state_dict"], strict=True)
  frozen = set(cli.freeze_parameters(model, "bertfrz4", "bertftn"))
  opt, _ = optim.build_optimizer(
      spec, [p for p in model.parameters() if p.requires_grad])
  opt.load_state_dict(ckpt_lib.optimizer_state_by_position(
      loaded["optimizer"], model, opt))
  names = {id(p): n for n, p in model.named_parameters()}
  held = {names[id(p)] for p in opt.state}
  assert held == {n for n, p in model.named_parameters() if p.requires_grad}
  assert not held & frozen
  slow = "slow_buffer" if kind == "Ranger" else "exp_avg"
  for p in opt.state:
    assert torch.equal(opt.state[p][slow],
                       loaded["optimizer"]["state"][names[id(p)]][slow])
