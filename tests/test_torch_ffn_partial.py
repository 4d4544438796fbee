"""The port's tensor-parallel FFN halves (the plain versions of B6 and B7,
which CPU tensors take) against the JAX package's Pallas kernels
``_pallas_ffn_partial_2d`` and ``_pallas_ffn_train_fwd_partial``, called
directly in interpret mode on the same numpy inputs.

Tolerances: fp32 2e-5 (sum-order noise); bf16 compute 2e-2 on the fp32
partial (both round x and the GELU output to bf16 at the same places,
with the JAX kernel's A&S erf against the port's exact erf deciding a
rounding now and then) and 2 bf16 ulps on inter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu_torch.ops import ffn

CDS = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(r, h, i, seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(r, h).astype(np.float32)
  w1 = (rng.randn(h, i) * 0.05).astype(np.float32)
  b1 = (rng.randn(i) * 0.05).astype(np.float32)
  w2 = (rng.randn(i, h) * 0.05).astype(np.float32)
  return x, w1, b1, w2


def _port(x, w1, b1, w2, cd):
  """JAX-layout numpy -> torch tensors in nn.Linear's layout, the weights
  in the compute dtype (as the kernel wrappers take them)."""
  t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
  return t(x), t(w1.T).to(cd), t(b1), t(w2.T).to(cd)


def _bf16_ulps(got, want):
  ref = np.maximum(np.abs(got), np.abs(want))
  return np.abs(got - want) / np.ldexp(1.0, np.frexp(ref)[1] - 8)


def _tol(name):
  return 2e-5 if name == "float32" else 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,h,i", [(64, 64, 128), (37, 48, 64)])
def test_partial_matches_pallas(dtype, r, h, i):
  jd, td = CDS[dtype]
  args = _inputs(r, h, i, seed=r + i)
  want = jax_ffn._pallas_ffn_partial_2d(*args, compute_dtype=jd,
                                        interpret=True)
  got = ffn.ffn_partial_plain(*_port(*args, td), compute_dtype=td)
  assert got.dtype == torch.float32 and got.shape == (r, h)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_tol(dtype),
                             atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,h,i", [(64, 64, 128), (37, 48, 64)])
def test_train_fwd_partial_matches_pallas(dtype, r, h, i):
  jd, td = CDS[dtype]
  args = _inputs(r, h, i, seed=3 * r + i)
  want_out, want_inter = jax_ffn._pallas_ffn_train_fwd_partial(
      *args, compute_dtype=jd, interpret=True)
  out, inter = ffn.ffn_train_fwd_partial_plain(*_port(*args, td),
                                               compute_dtype=td)
  assert inter.dtype == td and inter.shape == (r, i)
  np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                             rtol=_tol(dtype), atol=_tol(dtype))
  got_i = inter.float().numpy()
  want_i = np.asarray(want_inter, np.float32)
  if dtype == "float32":
    np.testing.assert_allclose(got_i, want_i, rtol=2e-5, atol=2e-5)
  else:
    close = (_bf16_ulps(got_i, want_i) <= 2) | (np.abs(got_i - want_i)
                                                <= 1e-6)
    assert close.all(), np.abs(got_i - want_i)[~close].max()


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_partials_sum_to_the_block(mp):
  """The ranks' partials, summed, then + b2 + x and the LayerNorm, are the
  single-device block; B7's inter shards are B2's inter, split."""
  r, h, i = 40, 64, 256
  x, w1, b1, w2 = _port(*_inputs(r, h, i, seed=mp), torch.float32)
  rng = np.random.RandomState(7)
  b2, beta = (torch.from_numpy((rng.randn(h) * 0.1).astype(np.float32))
              for _ in range(2))
  gamma = torch.from_numpy((1 + 0.1 * rng.randn(h)).astype(np.float32))
  n = i // mp
  parts = [ffn.ffn_train_fwd_partial_plain(
      x, w1[k * n:(k + 1) * n], b1[k * n:(k + 1) * n],
      w2[:, k * n:(k + 1) * n], compute_dtype=torch.float32)
           for k in range(mp)]
  y = sum(p for p, _ in parts) + b2 + x
  got = ffn.layer_norm(y, gamma, beta, eps=1e-12)
  ones = torch.ones(r, h)
  want, inter, _ = ffn.ffn_train_fwd_plain(x, ones, w1, b1, w2, b2, gamma,
                                           beta, eps=1e-12,
                                           compute_dtype=torch.float32)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
  np.testing.assert_allclose(torch.cat([u for _, u in parts], 1).numpy(),
                             inter.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", ["ffn_partial_cuda",
                                    "ffn_train_fwd_partial_cuda"])
def test_partial_kernel_wrappers_take_only_cuda_tensors(kernel):
  """A kernel wrapper given CPU tensors raises instead of falling back,
  and launches nothing."""
  fn = getattr(ffn, kernel)
  before = fn.launches
  with pytest.raises(ValueError, match="CUDA"):
    fn(*_port(*_inputs(16, 32, 64, seed=1), torch.float32),
       compute_dtype=torch.float32)
  assert fn.launches == before
