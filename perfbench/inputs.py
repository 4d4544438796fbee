"""Weights and inputs made from the run's seed, on the device, in a few
large calls.

The weights are one state dict in the program's names (the reference's
``param_spec``), which both sides take.  The inputs follow the recipe of
the program's ``flagship.make_batch``, copied here: every caption slot
valid, uniform word ids, Gaussian expert features and pooled features,
every expert row present, temporal ids uniform below the position
table's last row.  A pool of ``n`` videos is drawn at once and cut into
batches.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import model as ref_model

# One generator stream per purpose, all from the run's seed.
WEIGHTS, INPUTS, DROPOUT = range(3)


def generator(seed, stream, device):
  return torch.Generator(device=device).manual_seed(
      (int(seed) * 3 + stream) % 2 ** 63)


def make_weights(cfg, seed, device):
  """{name: tensor}: every normal draw in one call, then cut and scaled
  leaf by leaf (``param_spec``'s init)."""
  spec = ref_model.param_spec(cfg)
  sizes = [math.prod(shape) for _, shape, init in spec if init[0] == "normal"]
  flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device),
                     device=device)
  out, offset = {}, 0
  for name, shape, init in spec:
    if init == "zeros":
      out[name] = torch.zeros(shape, device=device)
    elif init == "ones":
      out[name] = torch.ones(shape, device=device)
    elif init == "count":
      out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    else:
      n = math.prod(shape)
      out[name] = flat[offset:offset + n].view(shape) * init[1]
      offset += n
  return out


def make_batches(cfg, sizes, seed, device, captions=1, stream=INPUTS):
  """Batches of the given numbers of videos (``captions`` each), drawn
  as one pool from ``seed``: token_ids [B, K, T, 2] int32 (id, mask),
  query_masks [B, K], and per expert features [B, L, dim], features_t /
  features_ind [B, L], features_avgpool / features_maxpool [B, dim]."""
  g = generator(seed, stream, device)
  n, t, rows = sum(sizes), cfg["max_text_words"], cfg["max_expert_tokens"]
  max_t = max(cfg["vid_bert"]["max_position_embeddings"] - 1, 2)
  ids = torch.randint(0, cfg["text_bert"]["vocab_size"], (n, captions, t),
                      generator=g, device=device, dtype=torch.int32)
  pool = {"token_ids": torch.stack([ids, torch.ones_like(ids)], -1),
          "query_masks": torch.ones(n, captions, device=device)}
  for key in ("features", "features_t", "features_ind", "features_avgpool",
              "features_maxpool"):
    pool[key] = {}
  for m, e in cfg["experts"].items():
    pool["features"][m] = torch.randn(n, rows, e["dim"], generator=g,
                                      device=device)
    pool["features_t"][m] = torch.randint(
        0, max_t, (n, rows), generator=g, device=device).float()
    pool["features_ind"][m] = torch.ones(n, rows, device=device)
    pooled = torch.randn(2, n, e["dim"], generator=g, device=device)
    pool["features_avgpool"][m], pool["features_maxpool"][m] = pooled
  starts = [sum(sizes[:i]) for i in range(len(sizes))]
  cut = lambda x, s, b: (x[s:s + b] if torch.is_tensor(x)
                         else {k: v[s:s + b] for k, v in x.items()})
  return [{k: cut(v, s, b) for k, v in pool.items()}
          for s, b in zip(starts, sizes)]
