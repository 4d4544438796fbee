"""The port's MoE similarity (plain version, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode.

fp32 on both sides; the tolerance (1e-5) is fp32 sum-order noise over
K = M * D products of unit-scale rows.  Then the choice of the kernel's
tile shape (a pure function of Q, V and the SM count) and the wrapper's
refusal of CPU tensors whatever tile is asked for.
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


SIZES = (1, 32, 37, 1_000, 20_000, 50_000)
H100_SMS = 132


def _blocks(tile, q, v):
  rows, cols = similarity.TILES[tile]
  return -(-q // rows) * -(-v // cols)


@pytest.mark.parametrize("q", SIZES)
def test_pick_tile_is_pure_and_total(q):
  for v in SIZES:
    tile = similarity.pick_tile(q, v, H100_SMS)
    assert tile in range(len(similarity.TILES))
    assert tile == similarity.pick_tile(q, v, H100_SMS)


def test_pick_tile_fills_the_card():
  # The eval's 1000 x 1000: no tile that leaves SMs without a block.
  assert _blocks(similarity.pick_tile(1_000, 1_000, H100_SMS),
                 1_000, 1_000) >= 128
  # Many waves either way: the largest tile (fewest shared loads per FMA).
  largest = max(range(len(similarity.TILES)),
                key=lambda i: similarity.TILES[i][0] * similarity.TILES[i][1])
  assert similarity.pick_tile(20_000, 20_000, H100_SMS) == largest
  assert similarity.pick_tile(50_000, 50_000, H100_SMS) == largest
  # The switch is at FULL_CARD blocks of the largest tile per SM: 4,000 x
  # 4,000 is 15 on an H100, 5,000 x 5,000 is 24.
  assert similarity.pick_tile(4_000, 4_000, H100_SMS) != largest
  assert similarity.pick_tile(5_000, 5_000, H100_SMS) == largest
  # A smaller card is full sooner.
  assert similarity.pick_tile(1_000, 1_000, 4) == largest


@pytest.mark.parametrize("n", [1, 37, 1_000])
def test_k_major_scratch_rows_are_16_byte_multiples(n):
  scratch = similarity.k_major_scratch(torch.zeros(n, 6))
  assert scratch.shape[0] == 6 and scratch.shape[1] % 4 == 0
  assert n <= scratch.shape[1] < n + 4
  assert scratch.dtype == torch.float32 and scratch.is_contiguous()


@pytest.mark.parametrize("tile", [None, 0, 1, 99])
def test_sim_cuda_refuses_cpu_tensors_whatever_the_tile(tile):
  text, vid, tw, vw = _inputs(4, 3, 2, 3, seed=0)
  t = torch.from_numpy
  args = (t(text).reshape(4, 6), t(vid).reshape(3, 6), t(tw), t(vw))
  before = similarity.sim_cuda.launches
  with pytest.raises(ValueError, match="CUDA"):
    similarity.sim_cuda(*args, tile=tile)
  assert similarity.sim_cuda.launches == before
