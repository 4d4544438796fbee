"""Carry the JAX package's CENet parameters over to the port.

``state_dict_from_flax`` maps the flax tree (as nested dicts of numpy
arrays) onto the port's state-dict names, which are the reference's:
Dense kernels [in, out] become Linear weights [out, in], LayerNorm
scale/bias become weight/bias, BatchNorm batch_stats mean/var become
running_mean/running_var.  It is the flagship subset of
scripts/convert_checkpoint.py:export_state_dict (no pooler, no
position_ids buffer: the port's CENet has neither), and raises on any
leaf it cannot place.

``shard_state_dict`` cuts a whole state dict (from it or from a
single-device model) to one tensor-parallel rank's shards, in the layout
a ``CENet(tp=)`` reports in its ``shard_dims``; ``gather_state_dict``
puts the ranks' shards back together, for checks.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

_BERT_SUB = {"query": "attention.self.query", "key": "attention.self.key",
             "value": "attention.self.value",
             "attn_out": "attention.output.dense",
             "ffn_inter": "intermediate.dense", "ffn_out": "output.dense"}
_BERT_LN = {"attn_ln": "attention.output", "ffn_ln": "output"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _ln(tower):
  return "LayerNorm" if tower == "txt" else "layer_norm"


def _param_name(path: str):
  """Flax params path -> (torch name, transpose), or None."""
  m = re.match(r"^(txt|vid)_bert/(word|position|token_type)_embeddings"
               r"/embedding$", path)
  if m:
    return f"{m[1]}_bert.embeddings.{m[2]}_embeddings.weight", False
  m = re.match(r"^(txt|vid)_bert/embeddings_ln/(scale|bias)$", path)
  if m:
    return f"{m[1]}_bert.embeddings.{_ln(m[1])}.{_LEAF[m[2]]}", False
  m = re.match(r"^(txt|vid)_bert/encoder/layer_(\d+)/(\w+)/(kernel|bias)$",
               path)
  if m and m[3] in _BERT_SUB:
    return (f"{m[1]}_bert.encoder.layer.{m[2]}.{_BERT_SUB[m[3]]}."
            f"{_LEAF[m[4]]}", m[4] == "kernel")
  m = re.match(r"^(txt|vid)_bert/encoder/layer_(\d+)/(\w+)/(scale|bias)$",
               path)
  if m and m[3] in _BERT_LN:
    return (f"{m[1]}_bert.encoder.layer.{m[2]}.{_BERT_LN[m[3]]}."
            f"{_ln(m[1])}.{_LEAF[m[4]]}", False)
  m = re.match(r"^video_dim_reduce_(\w+)/fc/(kernel|bias)$", path)
  if m:
    return f"video_dim_reduce.{m[1]}.fc.{_LEAF[m[2]]}", m[2] == "kernel"
  m = re.match(r"^text_gu_(\w+)/(fc|cg/fc)/(kernel|bias)$", path)
  if m:
    sub = m[2].replace("/", ".")
    return f"text_GU.{m[1]}.{sub}.{_LEAF[m[3]]}", m[3] == "kernel"
  m = re.match(r"^text_gu_(\w+)/cg/batch_norm/bn/(scale|bias)$", path)
  if m:
    return f"text_GU.{m[1]}.cg.batch_norm.{_LEAF[m[2]]}", False
  m = re.match(r"^moe_fc_txt_(\w+)/(kernel|bias)$", path)
  if m:
    return f"moe_fc_txt.{m[1]}.{_LEAF[m[2]]}", m[2] == "kernel"
  return None


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
  flat = {}
  for key, val in tree.items():
    path = f"{prefix}/{key}" if prefix else key
    if isinstance(val, Mapping):
      flat.update(_flatten(val, path))
    else:
      flat[path] = np.asarray(val)
  return flat


def state_dict_from_flax(params: Mapping, batch_stats: Mapping):
  """Flax {params, batch_stats} (nested dicts of numpy arrays) -> the
  port's CENet state dict of torch tensors."""
  sd = {}
  for path, arr in _flatten(params).items():
    entry = _param_name(path)
    if entry is None:
      raise KeyError(f"no port name for flax parameter {path}")
    name, transpose = entry
    sd[name] = arr.T if transpose else arr
  for path, arr in _flatten(batch_stats).items():
    m = re.match(r"^text_gu_(\w+)/cg/batch_norm/bn/(mean|var)$", path)
    if m is None:
      raise KeyError(f"no port name for flax batch stat {path}")
    base = f"text_GU.{m[1]}.cg.batch_norm"
    sd[f"{base}.running_{m[2]}"] = arr
    sd[f"{base}.num_batches_tracked"] = np.asarray(0, np.int64)
  return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], tp,
                     dims: Mapping[str, int]):
  """A whole state dict -> this rank's (``tp``, a
  ``parallel.TensorParallel``): each parameter named in ``dims`` (name ->
  the dim it is split on, a ``CENet(tp=tp)``'s ``shard_dims``) sliced
  along its dim and made contiguous; the rest as it is.  Loads into that
  ``CENet`` with ``strict=True``."""
  out = {}
  for name, t in state_dict.items():
    if name in dims:
      n = t.shape[dims[name]] // tp.size
      t = t.narrow(dims[name], tp.rank * n, n).contiguous()
    out[name] = t
  return out


def gather_state_dict(state_dict: Mapping[str, torch.Tensor], tp,
                      dims: Mapping[str, int]):
  """The ranks' shards (``dims``: name -> the dim it is split on, as
  ``shard_state_dict`` takes them) put back together on every rank, as
  CPU tensors; the other entries copied to the CPU as they are.  A
  collective: every rank of ``tp`` calls it.  Gathers through CPU copies
  (gloo has no all_gather of CUDA tensors); a check, not a path of the
  model."""
  out = {}
  for name, t in state_dict.items():
    t = t.detach().cpu()
    if name in dims:
      parts = [torch.empty_like(t) for _ in range(tp.size)]
      dist.all_gather(parts, t.contiguous(), group=tp.group)
      t = torch.cat(parts, dims[name])
    out[name] = t
  return out
