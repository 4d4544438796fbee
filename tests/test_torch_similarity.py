"""The port's MoE similarity (plain version, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode.

fp32 on both sides; the tolerance (1e-5) is fp32 sum-order noise over
K = M * D products of unit-scale rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmt_tpu.ops import similarity as jax_similarity
from mmt_tpu_torch.ops import similarity


def _inputs(q, v, m, d, seed):
  rng = np.random.RandomState(seed)
  text = rng.randn(q, m, d).astype(np.float32)
  vid = rng.randn(v, m, d).astype(np.float32)
  text /= np.linalg.norm(text, axis=-1, keepdims=True)
  vid /= np.linalg.norm(vid, axis=-1, keepdims=True)
  tw = rng.rand(q, m).astype(np.float32)
  vw = rng.rand(v, m).astype(np.float32)
  tw /= tw.sum(-1, keepdims=True)
  vw /= vw.sum(-1, keepdims=True)
  vw[1] = 0.0   # a video with no modality weight: hits the 1e-5 guard
  return text, vid, tw, vw


def _pallas(text, vid, tw, vw):
  with pltpu.force_tpu_interpret_mode():
    return np.asarray(jax_similarity._pallas_moe_similarity(
        jnp.asarray(text), jnp.asarray(vid), jnp.asarray(tw),
        jnp.asarray(vw)))


@pytest.mark.parametrize("merge,num_caps", [("indep", 1), ("indep", 2),
                                            ("avg", 2)])
def test_moe_similarity_matches_pallas(merge, num_caps):
  b, v, m, d = 9, 13, 3, 32
  text, vid, tw, vw = _inputs(b * num_caps, v, m, d, seed=num_caps)
  full = _pallas(text, vid, tw, vw)
  want = (full.reshape(b, num_caps, v).mean(1) if merge == "avg" else full)
  t = torch.from_numpy
  got = similarity.moe_similarity(t(text), t(vid), t(tw), t(vw),
                                  merge=merge, num_caps=num_caps).numpy()
  assert np.all(np.isfinite(got))
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_zero_weight_guard_matches_pallas():
  text, vid, tw, vw = _inputs(6, 5, 2, 16, seed=7)
  tw[2] = 0.0
  vw[:] = 0.0
  want = _pallas(text, vid, tw, vw)
  t = torch.from_numpy
  got = similarity.sim_plain(
      t(text * tw[:, :, None]).reshape(6, -1),
      t(vid * vw[:, :, None]).reshape(5, -1), t(tw), t(vw)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unknown_merge_raises():
  text, vid, tw, vw = _inputs(2, 2, 2, 4, seed=0)
  t = torch.from_numpy
  with pytest.raises(ValueError):
    similarity.moe_similarity(t(text), t(vid), t(tw), t(vw), merge="max")
