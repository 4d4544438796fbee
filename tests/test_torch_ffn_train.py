"""The port's train-time FFN block (B2 forward, B3 backward and the plain
weight gradients, through ``FFNBlockTrain``; the plain versions, which
CPU tensors take) against the JAX package's, with its Pallas kernels in
interpret mode.

Both packages get the same numpy inputs and the same explicit dropout
mask.  fp32 forward agrees to sum-order noise (2e-5); the gradients to
2e-4 relative / 1e-5 absolute, which leaves room for the JAX backward
kernel's A&S erf (max error 1.5e-7) against the port's exact erf.  bf16
rounds the same operands at the same places, so the compute-dtype outputs
agree to within a bf16 ulp or two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu_torch.ops import ffn

NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def _inputs(r, h, i, seed, p=0.25):
  rng = np.random.RandomState(seed)
  x = rng.randn(r, h).astype(np.float32)
  w1 = (rng.randn(h, i) * 0.05).astype(np.float32)
  b1 = (rng.randn(i) * 0.05).astype(np.float32)
  w2 = (rng.randn(i, h) * 0.05).astype(np.float32)
  b2 = (rng.randn(h) * 0.05).astype(np.float32)
  gamma = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
  beta = (0.1 * rng.randn(h)).astype(np.float32)
  drop = ((rng.rand(r, h) >= p).astype(np.float32) / (1.0 - p))
  return (x, w1, b1, w2, b2, gamma, beta), drop


def _torch_args(args):
  """JAX-layout numpy args -> torch tensors in nn.Linear's layout."""
  x, w1, b1, w2, b2, gamma, beta = args
  return [torch.from_numpy(a.copy()) for a in
          (x, w1.T, b1, w2.T, b2, gamma, beta)]


def _port_train(targs, drop, cd=torch.float32):
  x, w1, b1, w2, b2, gamma, beta = targs
  return ffn.ffn_block_train(x, torch.from_numpy(drop), w1, b1, w2, b2,
                             gamma, beta, eps=1e-12, compute_dtype=cd)


@pytest.mark.parametrize("r,h,i", [(64, 64, 256), (37, 48, 128)])
def test_train_forward_matches_pallas_fp32(r, h, i):
  args, drop = _inputs(r, h, i, seed=r)
  want = jax_ffn.ffn_block_train(args[0], drop, *args[1:], eps=1e-12,
                                 compute_dtype=jnp.float32, interpret=True)
  got = _port_train(_torch_args(args), drop)
  assert got.dtype == torch.float32 and got.shape == (r, h)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                             atol=2e-5)


def test_train_forward_ragged_3d():
  args, drop = _inputs(70, 64, 256, seed=5)
  x3, drop3 = args[0].reshape(7, 10, 64), drop.reshape(7, 10, 64)
  want = jax_ffn.ffn_block_train(x3, drop3, *args[1:], eps=1e-12,
                                 compute_dtype=jnp.float32, interpret=True)
  got = _port_train(_torch_args((x3,) + args[1:]), drop3)
  assert got.shape == (7, 10, 64)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                             atol=2e-5)


def test_train_gradients_match_jax_fp32():
  """All seven gradients of sum(out * cos(out)) through FFNBlockTrain
  against jax.grad through the JAX package's custom_vjp (B2 and B3 in
  interpret mode, XLA weight gradients)."""
  args, drop = _inputs(48, 64, 256, seed=19)

  def loss(*a):
    out = jax_ffn.ffn_block_train(a[0], drop, *a[1:], eps=1e-12,
                                  compute_dtype=jnp.float32, interpret=True)
    return jnp.sum(out * jnp.cos(out))

  want = jax.grad(loss, argnums=tuple(range(7)))(*args)
  targs = [t.requires_grad_() for t in _torch_args(args)]
  out = _port_train(targs, drop)
  got = torch.autograd.grad((out * torch.cos(out)).sum(), targs)
  for name, g, w in zip(NAMES, got, want):
    w = np.asarray(w)
    if name in ("w1", "w2"):
      w = w.T
    assert g.dtype == torch.float32, name
    np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=1e-5,
                               err_msg=name)


def test_train_block_p0_equals_eval_block():
  args, _ = _inputs(40, 64, 128, seed=23)
  targs = _torch_args(args)
  ones = np.ones((40, 64), np.float32)
  train = _port_train(targs, ones)
  x, w1, b1, w2, b2, gamma, beta = targs
  evald = ffn.ffn_block(x, w1, b1, w2, b2, gamma, beta, eps=1e-12,
                        compute_dtype=torch.float32)
  np.testing.assert_allclose(train.detach().numpy(), evald.numpy(),
                             rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("add_dz", [True, False])
def test_train_backward_kernel_matches_pallas(add_dz):
  """B3's plain version against _pallas_ffn_train_bwd (interpret), given
  the same residuals; add_dz=False is the tensor-parallel partial."""
  r, h, i = 40, 64, 256
  args, drop = _inputs(r, h, i, seed=29)
  x, w1, b1, w2, b2, gamma, beta = args
  _, inter, z = jax_ffn._pallas_ffn_train_fwd(
      x, drop, w1, b1, w2, b2, gamma, beta, eps=1e-12,
      compute_dtype=jnp.float32, interpret=True)
  dy = np.random.RandomState(31).randn(r, h).astype(np.float32)
  want = jax_ffn._pallas_ffn_train_bwd(
      dy, z, inter, drop, w1, w2, gamma, eps=1e-12,
      compute_dtype=jnp.float32, interpret=True, add_dz=add_dz)
  t = lambda a: torch.from_numpy(np.asarray(a).copy())
  got = ffn.ffn_train_bwd_plain(t(dy), t(z), t(inter), t(drop), t(w1.T),
                                t(w2.T), t(gamma), eps=1e-12,
                                compute_dtype=torch.float32, add_dz=add_dz)
  for name, g, w in zip(("dx", "dz", "dinter"), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                               atol=1e-5, err_msg=name)


def _bf16_ulps(got, want):
  """|got - want| in bf16 ulps of the larger magnitude (fp32 arrays)."""
  ref = np.maximum(np.abs(got), np.abs(want))
  ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
  return np.abs(got - want) / ulp


def test_train_kernels_match_pallas_bf16():
  """bf16 compute: B2's and B3's plain versions against the Pallas
  kernels (interpret) on the same inputs; the fp32 outputs to the B1
  bf16 tolerance, the bf16 outputs within 2 bf16 ulps (1e-6 absolute
  near zero, where fp32 sum order decides the rounding)."""
  r, h, i = 41, 48, 128
  args, drop = _inputs(r, h, i, seed=37)
  x, w1, b1, w2, b2, gamma, beta = args
  want_f = jax_ffn._pallas_ffn_train_fwd(
      x, drop, w1, b1, w2, b2, gamma, beta, eps=1e-12,
      compute_dtype=jnp.bfloat16, interpret=True)
  t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
  bf = torch.bfloat16
  got_f = ffn.ffn_train_fwd_plain(t(x), t(drop), t(w1.T).to(bf), t(b1),
                                  t(w2.T).to(bf), t(b2), t(gamma), t(beta),
                                  eps=1e-12, compute_dtype=bf)
  dy = np.random.RandomState(41).randn(r, h).astype(np.float32)
  _, inter, z = want_f
  want_b = jax_ffn._pallas_ffn_train_bwd(
      dy, z, inter, drop, w1, w2, gamma, eps=1e-12,
      compute_dtype=jnp.bfloat16, interpret=True)
  got_b = ffn.ffn_train_bwd_plain(
      t(dy), t(z).to(bf), t(inter).to(bf), t(drop), t(w1.T).to(bf),
      t(w2.T).to(bf), t(gamma), eps=1e-12, compute_dtype=bf)
  for name, g, w in zip(("out", "inter", "z", "dx", "dz", "dinter"),
                        (*got_f, *got_b), (*want_f, *want_b)):
    g, w = g.float().numpy(), np.asarray(w, np.float32)
    if name in ("out", "dx"):
      np.testing.assert_allclose(g, w, rtol=0, atol=2e-2, err_msg=name)
    else:
      close = (_bf16_ulps(g, w) <= 2) | (np.abs(g - w) <= 1e-6)
      assert close.all(), (name, np.abs(g - w)[~close].max())


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_train_kernel_wrappers_take_only_cuda_tensors(which):
  """The CPU path never reaches the kernels (counters unchanged), and a
  kernel wrapper given CPU tensors raises instead of falling back."""
  args, drop = _inputs(16, 32, 64, seed=43)
  targs = _torch_args(args)
  before = (ffn.ffn_train_fwd_cuda.launches, ffn.ffn_train_bwd_cuda.launches)
  out = _port_train([t.requires_grad_() for t in targs], drop)
  out.sum().backward()
  assert (ffn.ffn_train_fwd_cuda.launches,
          ffn.ffn_train_bwd_cuda.launches) == before
  x, w1, b1, w2, b2, gamma, beta = (t.detach() for t in targs)
  d = torch.from_numpy(drop)
  with pytest.raises(ValueError, match="CUDA"):
    if which == "fwd":
      ffn.ffn_train_fwd_cuda(x, d, w1, b1, w2, b2, gamma, beta, eps=1e-12,
                             compute_dtype=torch.float32)
    else:
      ffn.ffn_train_bwd_cuda(x, x, torch.zeros(16, 64), d, w1, w2, gamma,
                             eps=1e-12, compute_dtype=torch.float32)
