"""Gradients of the eval FFN blocks on the kernel path.

On the card ``ffn_block`` and ``ffn_block_tp`` launch B1 / B6, which
have no backward of their own: under autograd they run inside
``ops.ffn._RefVjp``, whose backward is the vjp of ``ffn_block_ref`` (the
port of the JAX package's XLA reference) recomputed, as
mmt_tpu/ops/ffn.py:_fused_ffn_fn's ``bwd`` is jax.vjp of
``xla_ffn_block``.  Here ``ops.use_kernel`` is patched to True and the
kernel wrappers to counted no-grad calls of the plain versions, so the
kernel path runs on the CPU.  Its gradients must equal plain autograd's
in fp32 (1e-5), and jax.grad through the JAX package's ``ffn_block``
(Pallas kernel interpreted) in fp32 (1e-5) and in bf16 (each gradient
within BF16_GRAD_TOL relative L2); a no-grad call must not enter the
autograd wrapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu_torch import flagship, ops
from mmt_tpu_torch.ops import ffn

R, H, I = 19, 32, 64


class OneRank:
  """A tensor-parallel group of one rank: the all-reduce is a copy."""
  rank, size = 0, 1

  @staticmethod
  def all_reduce(x):
    return x.to(torch.float32, copy=True)


def _stand_in(monkeypatch, name, plain):
  """Patch ``ffn.<name>`` to a counted no-grad call of ``plain``; returns
  the list the calls are counted in."""
  calls = []

  def kernel(*args, tile=None, **kw):
    calls.append(torch.is_grad_enabled())
    with torch.no_grad():
      return plain(*args, **kw)

  monkeypatch.setattr(ffn, name, kernel)
  return calls


def _operands(seed):
  rng = np.random.RandomState(seed)
  t = lambda *s, scale=1.0, shift=0.0: torch.from_numpy(
      (shift + scale * rng.randn(*s)).astype(np.float32))
  return dict(x=t(2, R, H), w1=t(I, H, scale=0.1), b1=t(I, scale=0.1),
              w2=t(H, I, scale=0.1), b2=t(H, scale=0.1),
              gamma=t(H, scale=0.1, shift=1.0), beta=t(H, scale=0.1))


def _run(block, ops_in, dy, cd=torch.float32):
  """Output and gradients of every operand of the eval block, the fp32
  master weights cast to ``cd`` in the graph (as models/bert.py's
  Linear.cast)."""
  leaves = {n: v.clone().requires_grad_(True) for n, v in ops_in.items()}
  x, w1, b1, w2, *rest = leaves.values()
  args = (x, w1.to(cd), b1, w2.to(cd), *rest)
  if block == "partial":
    out = ffn.ffn_block_tp(*args, eps=1e-12, tp=OneRank(), compute_dtype=cd)
  else:
    out = ffn.ffn_block(*args, eps=1e-12, compute_dtype=cd)
  grads = torch.autograd.grad((out * dy).sum(), list(leaves.values()))
  return out, dict(zip(leaves, grads))


@pytest.mark.parametrize("block,kernel,plain", [
    ("block", "ffn_block_cuda", ffn.ffn_block_plain),
    ("partial", "ffn_partial_cuda", ffn.ffn_partial_plain)])
def test_eval_block_kernel_path_has_the_plain_gradients(monkeypatch, block,
                                                       kernel, plain):
  operands = _operands(seed=3)
  dy = torch.from_numpy(np.random.RandomState(4).randn(2, R, H)
                        .astype(np.float32))
  want_out, want = _run(block, operands, dy)
  calls = _stand_in(monkeypatch, kernel, plain)
  monkeypatch.setattr(ops, "use_kernel", lambda x, family: True)
  got_out, got = _run(block, operands, dy)
  assert calls == [False]          # launched once, outside the graph
  assert got_out.grad_fn is not None
  np.testing.assert_allclose(got_out.detach().numpy(),
                             want_out.detach().numpy(), rtol=0, atol=1e-6)
  # The partial's operands are x, w1, b1, w2; b2, gamma and beta act after
  # the all-reduce, in plain torch, on both paths.
  for name, g in want.items():
    np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


# bf16: the port's and the JAX package's vjp of the same XLA reference
# round the compute-dtype cotangents in different places (torch's GELU
# backward in fp32, XLA's op by op); measured at most 6.7e-3 here.
BF16_GRAD_TOL = 1e-2


def _jax_grads(ops_in, dy, cd):
  """jax.grad of sum(ffn_block * dy) through the JAX package's eval block
  (Pallas kernel interpreted forward, jax.vjp of xla_ffn_block backward),
  its [H, I] / [I, H] weights the transposes of the port's."""
  def loss(x, w1, b1, w2, b2, gamma, beta):
    out = jax_ffn.ffn_block(x, w1.T, b1, w2.T, b2, gamma, beta, eps=1e-12,
                            compute_dtype=cd, interpret=True)
    return (out * jnp.asarray(dy.numpy())).sum()
  grads = jax.grad(loss, argnums=tuple(range(len(ops_in))))(
      *(jnp.asarray(v.numpy()) for v in ops_in.values()))
  return dict(zip(ops_in, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,kernel,plain", [
    ("block", "ffn_block_cuda", ffn.ffn_block_plain),
    ("partial", "ffn_partial_cuda", ffn.ffn_partial_plain)])
def test_eval_block_kernel_path_has_the_jax_gradients(monkeypatch, block,
                                                     kernel, plain, dtype):
  """The kernel path's gradients (the partial's through a group of one
  rank) against jax.grad through mmt_tpu's ffn_block on the same inputs."""
  operands = _operands(seed=3)
  dy = torch.from_numpy(np.random.RandomState(4).randn(2, R, H)
                        .astype(np.float32))
  want = _jax_grads(operands, dy, getattr(jnp, dtype))
  calls = _stand_in(monkeypatch, kernel, plain)
  monkeypatch.setattr(ops, "use_kernel", lambda x, family: True)
  _, got = _run(block, operands, dy, getattr(torch, dtype))
  assert calls == [False]
  for name, g in want.items():
    if dtype == "float32":
      np.testing.assert_allclose(got[name].numpy(), g, rtol=1e-5, atol=1e-5,
                                 err_msg=name)
    else:
      rel = np.linalg.norm(got[name].numpy() - g) / np.linalg.norm(g)
      assert rel <= BF16_GRAD_TOL, (name, rel)


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode",
                                       "no_operand_requires_grad"])
def test_eval_block_without_autograd_calls_the_kernel_directly(
    monkeypatch, grad_mode):
  calls = _stand_in(monkeypatch, "ffn_block_cuda", ffn.ffn_block_plain)
  monkeypatch.setattr(ops, "use_kernel", lambda x, family: True)
  entered = []
  monkeypatch.setattr(ffn._RefVjp, "apply",
                      lambda *a: entered.append(1))
  operands = _operands(seed=5)
  ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
         "no_operand_requires_grad": torch.enable_grad}[grad_mode]
  with ctx():
    out = ffn.ffn_block(*operands.values(), eps=1e-12,
                        compute_dtype=torch.float32)
  assert len(calls) == 1 and not entered and out.grad_fn is None


def test_eval_model_kernel_path_has_the_plain_gradients(monkeypatch):
  """The whole tiny flagship in eval mode under autograd: with the FFN
  kernels stood in for, every parameter's gradient equals plain
  autograd's; before the fix the graph stopped at each tower's last FFN
  block, so every parameter below it had none."""
  arch = flagship.flagship_arch(tiny=True)
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, seed=2)
  batch = flagship.batch_to_torch(
      flagship.make_batch(arch["expert_dims"], 3, vocab=512, seed=6), "cpu")
  rng = np.random.RandomState(7)

  def grads():
    model.zero_grad()
    out = model(batch)
    loss = sum((v * torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32))).sum()
               for _, v in sorted(out.items()))
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}

  want = grads()
  rng = np.random.RandomState(7)
  calls = _stand_in(monkeypatch, "ffn_block_cuda", ffn.ffn_block_plain)
  monkeypatch.setattr(ops, "use_kernel", lambda x, family: True)
  got = grads()
  n_layers = (model.txt_bert.cfg.num_hidden_layers
              + model.vid_bert.cfg.num_hidden_layers)
  assert len(calls) == n_layers
  assert set(got) == set(want)
  assert any(".layer.0.intermediate.dense.weight" in n for n in got)
  for name, g in want.items():
    np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
