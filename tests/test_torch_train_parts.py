"""The port's training parts against the JAX package's: losses, optimizers
and schedules, dropout, train-mode BatchNorm, ``Linear.cast`` under
autograd, and the eval forward with ``train=False``.

Losses and optimizer steps agree to 1e-6 (fp32, the same arithmetic in
another order); schedules exactly.  Dropout streams differ between the
packages by design (explicit torch generators), so the masks are held to
their distribution and to the seed.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmt_tpu.train import losses as jax_losses
from mmt_tpu.train import optim as jax_optim
from mmt_tpu_torch import flagship
from mmt_tpu_torch.models import components
from mmt_tpu_torch.models.bert import Linear
from mmt_tpu_torch.ops import attention, dropout
from mmt_tpu_torch.train import losses, optim, step


@pytest.mark.parametrize("name,args", [
    ("max_margin", dict(margin=0.05, fix_norm=True)),
    ("max_margin", dict(margin=0.2, fix_norm=False)),
    ("info_nce", {})])
def test_losses_match_jax(name, args):
  x = np.random.RandomState(1).randn(9, 9).astype(np.float32) * 0.3
  if name == "max_margin":
    want = jax_losses.max_margin_ranking_loss(**args)(jnp.asarray(x))
    got = losses.max_margin_ranking_loss(**args)(torch.from_numpy(x))
  else:
    want = jax_losses.info_nce_loss()(jnp.asarray(x))
    got = losses.info_nce_loss()(torch.from_numpy(x))
  assert abs(float(got) - float(want)) <= 1e-6


def _optimizer_runs(spec, n_steps=3):
  """n_steps of ``spec`` on fixed grads: (port params, optax params)."""
  rng = np.random.RandomState(4)
  params = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}
  grads = [{k: rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(n_steps)]
  tx, _ = jax_optim.build_optimizer(spec)
  jp = {k: jnp.asarray(v) for k, v in params.items()}
  state = tx.init(jp)
  for g in grads:
    updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
    jp = optax.apply_updates(jp, updates)
  tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in params.items()}
  opt, base_lr = optim.build_optimizer(spec, list(tp.values()))
  assert base_lr == spec["args"]["lr"]
  for g in grads:
    for k, p in tp.items():
      p.grad = torch.from_numpy(g[k])
    opt.step()
  return ({k: p.detach().numpy() for k, p in tp.items()},
          {k: np.asarray(v) for k, v in jp.items()}, params, grads)


@pytest.mark.parametrize("spec", [
    {"type": "Adam", "args": {"lr": 1e-2, "weight_decay": 0}},
    {"type": "Adam", "args": {"lr": 1e-2, "weight_decay": 0.1}},
    {"type": "AdamW", "args": {"lr": 1e-2, "weight_decay": 0.05}},
    {"type": "SGD", "args": {"lr": 1e-2, "momentum": 0.9,
                             "weight_decay": 1e-3}}],
                         ids=["adam", "adam_wd", "adamw", "sgd_momentum_wd"])
def test_optimizers_match_optax(spec):
  got, want, _, _ = _optimizer_runs(spec)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_adam_weight_decay_is_decoupled():
  """JAX's Adam with weight decay is optax.adamw (decoupled decay); torch's
  Adam(weight_decay=...) adds the decay to the gradient instead and lands
  elsewhere, so the port maps it to AdamW."""
  spec = {"type": "Adam", "args": {"lr": 1e-2, "weight_decay": 0.1}}
  _, want, params, grads = _optimizer_runs(spec)
  tp = [torch.nn.Parameter(torch.from_numpy(v.copy()))
        for v in params.values()]
  coupled = torch.optim.Adam(tp, lr=1e-2, weight_decay=0.1)
  for g in grads:
    for p, gv in zip(tp, g.values()):
      p.grad = torch.from_numpy(gv)
    coupled.step()
  assert max(float(np.abs(p.detach().numpy() - want[k]).max())
             for p, k in zip(tp, params)) > 1e-4


def test_unported_optimizer_raises():
  with pytest.raises(NotImplementedError, match="Ranger"):
    optim.build_optimizer({"type": "Ranger", "args": {"lr": 1e-3}},
                          [torch.nn.Parameter(torch.zeros(2))])


def test_schedules_match_jax():
  for args in ((5e-5, 1, 0.95), (1e-3, 3, 0.5)):
    want, got = jax_optim.step_lr(*args), optim.step_lr(*args)
    assert [got(e) for e in range(12)] == [want(e) for e in range(12)]
  for period in (0, 1, 7):
    want, got = jax_optim.linear_warmup(period), optim.linear_warmup(period)
    assert [got(s) for s in range(10)] == [want(s) for s in range(10)]


def test_dropout_mask_distribution_and_values():
  gen = torch.Generator().manual_seed(3)
  p = 0.1
  mask = dropout.dropout_mask((100_000,), p, gen, "cpu")
  assert mask.dtype == torch.float32
  values = set(torch.unique(mask).tolist())
  assert values == {0.0, float(torch.tensor(1.0) / (1.0 - p))}
  keep = float((mask > 0).float().mean())
  assert abs(keep - (1.0 - p)) <= 0.01
  assert bool((dropout.dropout_mask((7,), 0.0, None, "cpu") == 1).all())
  # Rate 0 draws nothing; any other rate needs an explicit generator.
  state = gen.get_state()
  x = torch.randn(4, 5)
  assert dropout.dropout(x, 0.0, gen) is x
  assert torch.equal(gen.get_state(), state)
  with pytest.raises(ValueError, match="Generator"):
    dropout.dropout(x, 0.5, None)


def test_attention_probability_dropout():
  """where(keep, probs / (1-p), 0) on the fp32 probabilities, before the
  cast to the value dtype, with the mask drawn from the generator."""
  rng = np.random.RandomState(2)
  q, k, v = (torch.from_numpy(rng.randn(2, 3, 5, 4).astype(np.float32))
             for _ in range(3))
  bias = torch.zeros(2, 1, 1, 5)
  got = attention.attention_bhsd(q, k, v, attn_bias=bias, dropout_p=0.3,
                                 generator=torch.Generator().manual_seed(9))
  probs = torch.softmax(q @ k.transpose(-1, -2) / 2.0, -1)
  keep = torch.rand(probs.shape, generator=torch.Generator().manual_seed(9))
  probs = torch.where(keep >= 0.3, probs / 0.7, torch.zeros_like(probs))
  np.testing.assert_allclose(got.numpy(), (probs @ v).numpy(), rtol=1e-6,
                             atol=1e-6)


def test_train_batchnorm_uses_biased_running_variance():
  """flax semantics: batch moments with the biased fast variance, running
  buffers 0.9 * old + 0.1 * batch; torch's BatchNorm1d would keep the
  unbiased variance."""
  torch.manual_seed(0)
  geus = [components.GatedEmbeddingUnit(6, 4) for _ in range(2)]
  x = torch.randn(5, 6)
  reference = torch.nn.BatchNorm1d(4, eps=components.BN_EPS, momentum=0.1)
  with torch.no_grad():
    gate = torch.stack([g.cg.fc(g.fc(x)) for g in geus], 1)   # [B, M, D]
  components.batched_gated_embedding(x, geus, train=True)
  for m, g in enumerate(geus):
    bn = g.cg.batch_norm
    var = gate[:, m].var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * gate[:, m].mean(0)).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    reference.reset_running_stats()
    reference.train()(gate[:, m])
    assert float((reference.running_var - bn.running_var).abs().max()) > 1e-4


def test_linear_cast_passes_gradients_under_autograd():
  lin = Linear(6, 3)
  x = torch.randn(4, 6)
  w, b = lin.cast(torch.bfloat16)
  assert w.dtype == torch.bfloat16 and w.requires_grad
  torch.nn.functional.linear(x.bfloat16(), w, b).float().sum().backward()
  assert lin.weight.grad is not None and lin.weight.grad.dtype == torch.float32
  np.testing.assert_allclose(lin.bias.grad.numpy(), np.full(3, 4.0))
  with torch.no_grad():   # without autograd: the cached detached copy
    w1, _ = lin.cast(torch.bfloat16)
    w2, _ = lin.cast(torch.bfloat16)
  assert w1 is w2 and not w1.requires_grad


def _tiny(seed=0):
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, seed=seed, train=True)
  arch = flagship.flagship_arch(tiny=True)
  batch = flagship.batch_to_torch(
      flagship.make_batch(arch["expert_dims"], 4, vocab=512, seed=8), "cpu")
  return model, batch


def _first_loss(gen_seed):
  model, batch = _tiny()
  opt, lr = optim.build_optimizer(
      {"type": "Adam", "args": {"lr": 5e-5}}, model.parameters())
  return float(step.train_step(
      model, opt, batch, loss_fn=losses.max_margin_ranking_loss(0.05, True),
      lr=lr, generator=torch.Generator().manual_seed(gen_seed)))


def test_train_step_dropout_follows_the_generator_seed():
  first = _first_loss(11)
  assert _first_loss(11) == first
  assert _first_loss(12) != first


def test_eval_forward_unchanged_by_train_flag():
  """train=False is the eval forward: no BatchNorm update, the same
  outputs with or without autograd, whatever generator is passed."""
  model, batch = _tiny()
  buffers = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
  with torch.inference_mode():
    want = model(batch)
  got = model(batch, train=False, generator=torch.Generator().manual_seed(1))
  for k in want:
    assert torch.equal(got[k].detach(), want[k]), k
  for k, v in buffers.items():
    assert torch.equal(model.state_dict()[k], v), k
  trained = model(batch, train=True,
                  generator=torch.Generator().manual_seed(1))
  assert not torch.equal(trained["text_embds"].detach(), want["text_embds"])
