"""The system under test, as the benchmark drives it: mmt_tpu_torch's
CENet built from a configuration file, its kernel library, its launch
counters.  The only harness module besides the mixes that imports the
program."""

from __future__ import annotations

import time

import torch

from mmt_tpu_torch import _build
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ffn, ranking, similarity

DTYPES = {"float32": torch.float32}
DROPOUTS = ("hidden_dropout_prob", "attention_probs_dropout_prob")


def load_kernels(device):
  """Build (at the first run in a checkout: nvcc, into the program's fixed
  build directory inside the checkout) and load the kernel library.
  Returns the seconds it took."""
  if torch.device(device).type != "cuda":
    return 0.0
  tic = time.perf_counter()
  _build.load_library()
  return time.perf_counter() - tic


def build_model(cfg, weights, device):
  """The program's CENet at ``cfg``'s widths and switches, holding
  ``weights`` (loaded strictly: every name and shape must match)."""
  if cfg["dtype"] not in DTYPES:
    raise ValueError(f"dtype {cfg['dtype']!r}: one of {sorted(DTYPES)}")
  text = cfg["text_bert"]
  model = CENet(
      expert_dims=cfg["experts"], vid_bert_params=cfg["vid_bert"],
      txt_bert_params={k: text[k] for k in DROPOUTS},
      text_bert_geometry={k: v for k, v in text.items() if k not in DROPOUTS},
      same_dim=cfg["same_dim"], compute_dtype=DTYPES[cfg["dtype"]],
      device=device, **cfg["switches"])
  model.load_state_dict(weights, strict=True)
  return model


def launch_counters():
  """{kernel family: the wrapper whose ``launches`` counts it}."""
  return {"B1": ffn.ffn_block_cuda, "B2": ffn.ffn_train_fwd_cuda,
          "B3": ffn.ffn_train_bwd_cuda, "B4": similarity.sim_cuda,
          "B5": ranking.fused_counts_cuda}
