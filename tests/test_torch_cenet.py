"""The port's CENet eval forward against the JAX package's, same weights.

A tiny flax CENet with the flagship switches runs with both Pallas
kernels in interpret mode; its parameters are carried over with
``state_dict_from_flax`` and loaded with ``strict=True``; both packages
get the same numpy batch.  fp32 throughout, so the tolerance is fp32
sum-order noise through two 2-layer towers (1e-4).
"""

import jax
import numpy as np
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.ops import ffn as flax_ffn
from mmt_tpu.ops import similarity as flax_similarity
from mmt_tpu.train import metrics as flax_metrics
from mmt_tpu_torch import convert, evaluate
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models.cenet import CENet, similarity_from_outputs
from mmt_tpu_torch.train import metrics
from tests.conftest import make_batch


def _flax_forward(arch, batch):
  model = FlaxCENet(**arch)
  variables = model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False)
  # Non-trivial BatchNorm running stats, so the eval-mode BN is exercised.
  rng = np.random.RandomState(5)
  stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
  for mod in stats:
    bn = stats[mod]["cg"]["batch_norm"]["bn"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
    bn["var"] = (np.abs(rng.randn(*bn["var"].shape)) + 0.5).astype(
        np.float32)
  variables = {"params": variables["params"], "batch_stats": stats}
  flax_ffn.use_pallas(True, interpret=True)
  flax_similarity.use_pallas(True, interpret=True)
  try:
    out = model.apply(variables, batch, train=False)
    sims = flax_sims(out, merge="indep")
  finally:
    flax_ffn.use_pallas(False)
    flax_similarity.use_pallas(False)
  out = {k: np.asarray(v) for k, v in out.items()}
  return variables, out, np.asarray(sims)


def test_cenet_matches_flax(tiny_arch):
  batch = make_batch(tiny_arch["expert_dims"], b=3, k=2, t=7, l=5)
  variables, want, want_sims = _flax_forward(tiny_arch, batch)

  model = CENet(**tiny_arch, device="cpu").eval()
  sd = convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"]),
      variables["batch_stats"])
  model.load_state_dict(sd, strict=True)
  tb = batch_to_torch(batch, "cpu")
  with torch.inference_mode():
    got = model(tb)
    sims = similarity_from_outputs(got, merge="indep")
  for key in ("text_embds", "vid_embds", "text_weights", "vid_weights"):
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                               atol=1e-4, err_msg=key)
  np.testing.assert_allclose(sims.numpy(), want_sims, rtol=1e-4, atol=1e-4)

  # The metrics of one sims matrix agree exactly between the packages.
  masks = batch["query_masks"]
  ref_sims = torch.from_numpy(want_sims.copy())
  for port_fn, flax_fn in ((metrics.t2v_metrics, flax_metrics.t2v_metrics),
                           (metrics.v2t_metrics, flax_metrics.v2t_metrics)):
    assert port_fn(ref_sims, masks) == flax_fn(want_sims, masks)

  # retrieval_eval over the same batch split in two chunks gives the
  # same matrix as the single forward.
  halves = [batch_to_torch({k: ({m: a[s] for m, a in v.items()}
                                if isinstance(v, dict) else v[s])
                            for k, v in batch.items()}, "cpu")
            for s in (slice(0, 2), slice(2, 3))]
  res = evaluate.retrieval_eval(model, halves)
  np.testing.assert_allclose(res["sims"].numpy(), sims.numpy(), rtol=1e-5,
                             atol=1e-6)
  assert res["t2v_metrics"] == metrics.t2v_metrics(sims, masks)
