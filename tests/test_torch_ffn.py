"""The port's fused FFN block (plain version, which CPU tensors take)
against the JAX package's Pallas kernel run in interpret mode.

Same numpy inputs for both; the JAX side takes the [H, I] / [I, H]
kernels, the port nn.Linear's [I, H] / [H, I] weights.  fp32 agrees to
sum-order noise (2e-5); bf16 rounds the same operands at the same places,
so it agrees to within a few bf16 ulps of the output (2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu_torch.ops import ffn


def _inputs(r, h, i, seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(r, h).astype(np.float32)
  w1 = (rng.randn(h, i) * 0.05).astype(np.float32)
  b1 = (rng.randn(i) * 0.05).astype(np.float32)
  w2 = (rng.randn(i, h) * 0.05).astype(np.float32)
  b2 = (rng.randn(h) * 0.05).astype(np.float32)
  gamma = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
  beta = (0.1 * rng.randn(h)).astype(np.float32)
  return x, w1, b1, w2, b2, gamma, beta


def _both(args, jax_dtype, torch_dtype, shape=None):
  x, w1, b1, w2, b2, gamma, beta = args
  if shape is not None:
    x = x.reshape(shape)
  want = jax_ffn.ffn_block(x, w1, b1, w2, b2, gamma, beta, eps=1e-12,
                           compute_dtype=jax_dtype, interpret=True)
  t = torch.from_numpy
  got = ffn.ffn_block(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2),
                      t(gamma), t(beta), eps=1e-12, compute_dtype=torch_dtype)
  return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("r,h,i", [(64, 64, 256), (37, 48, 128),
                                   (9, 64, 64)])
def test_ffn_block_matches_pallas_fp32(r, h, i):
  got, want = _both(_inputs(r, h, i, seed=r), jnp.float32, torch.float32)
  assert got.dtype == np.float32 and got.shape == (r, h)
  np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("r,h,i", [(96, 64, 256), (41, 48, 128)])
def test_ffn_block_matches_pallas_bf16(r, h, i):
  got, want = _both(_inputs(r, h, i, seed=3), jnp.bfloat16, torch.bfloat16)
  np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_ffn_block_3d_ragged_rows():
  got, want = _both(_inputs(70, 64, 256, seed=5), jnp.float32,
                    torch.float32, shape=(7, 10, 64))
  assert got.shape == (7, 10, 64)
  np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_layer_norm_matches_jax():
  rng = np.random.RandomState(11)
  y = (rng.randn(17, 96) * 3 + 1).astype(np.float32)
  gamma = (1.0 + 0.2 * rng.randn(96)).astype(np.float32)
  beta = (0.1 * rng.randn(96)).astype(np.float32)
  want = np.asarray(jax_ffn.layer_norm(y, gamma, beta, eps=1e-12))
  got = ffn.layer_norm(torch.from_numpy(y), torch.from_numpy(gamma),
                       torch.from_numpy(beta), eps=1e-12).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
