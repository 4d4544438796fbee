"""Gradients of the port's MoE similarity (``MoESimilarity``, the plain
version's forward on the CPU, closed-form backward) against jax.grad
through the JAX package's fused kernel (``_fused_sim_fn``: Pallas forward
in interpret mode, ``_fused_bwd``).

Both take the unscaled embeddings and weights, so the port's gradients
flow through ``moe_similarity``'s pre-scaling under autograd.  The merge
is 'avg' with one and two captions per video; one caption row has all-zero
weights, so its denominators hit the 1e-5 guard.  fp32 throughout: atol
1e-5, and rtol 1e-6 for the guarded row's weight gradients, which the
1/1e-5 guard scales to ~1e4 (fp32 rounding there is ~4e-3 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import similarity as jax_sim
from mmt_tpu_torch.ops import similarity


def _inputs(q, v, m, d, seed):
  rng = np.random.RandomState(seed)
  te = rng.randn(q, m, d).astype(np.float32)
  ve = rng.randn(v, m, d).astype(np.float32)
  te /= np.linalg.norm(te, axis=-1, keepdims=True)
  ve /= np.linalg.norm(ve, axis=-1, keepdims=True)
  tw = rng.rand(q, m).astype(np.float32)
  vw = rng.rand(v, m).astype(np.float32)
  tw /= tw.sum(-1, keepdims=True)
  vw /= vw.sum(-1, keepdims=True)
  tw[1] = 0.0
  return te, ve, tw, vw


@pytest.mark.parametrize("num_caps", [1, 2])
def test_similarity_gradients_match_jax(num_caps):
  v, m, d = 6, 3, 16
  q = v * num_caps
  args = _inputs(q, v, m, d, seed=num_caps)
  # A fixed cotangent, so every entry of the merged matrix matters.
  cot = np.random.RandomState(7).randn(v, v).astype(np.float32)
  fused = jax_sim._fused_sim_fn(True)

  def loss(te, ve, tw, vw):
    sims = fused(te, ve, tw, vw)
    if num_caps > 1:
      sims = sims.reshape(v, num_caps, v).mean(1)
    return jnp.sum(sims * cot)

  want = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
  targs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
  sims = similarity.moe_similarity(*targs, merge="avg", num_caps=num_caps)
  assert sims.shape == (v, v)
  got = torch.autograd.grad((sims * torch.from_numpy(cot)).sum(), targs)
  for name, g, w in zip(("text_embds", "vid_embds", "text_weights",
                         "vid_weights"), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-5, err_msg=name)
  if num_caps == 1:  # the zero-weight caption's similarities are 0
    assert float(sims[1].detach().abs().max()) == 0.0


def test_similarity_function_matches_plain_forward():
  te, ve, tw, vw = (torch.from_numpy(a) for a in _inputs(5, 4, 3, 8, 3))
  t = (te * tw[:, :, None]).reshape(5, 24)
  vv = (ve * vw[:, :, None]).reshape(4, 24)
  np.testing.assert_array_equal(
      similarity.MoESimilarity.apply(t, vv, tw, vw).numpy(),
      similarity.sim_plain(t, vv, tw, vw).numpy())
