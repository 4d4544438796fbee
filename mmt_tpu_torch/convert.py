"""Carry the JAX package's CENet parameters over to the port.

``state_dict_from_flax`` maps the flax tree (as nested dicts of numpy
arrays) onto the port's state-dict names, which are the reference's:
Dense kernels [in, out] become Linear weights [out, in], LayerNorm
scale/bias become weight/bias, BatchNorm batch_stats mean/var become
running_mean/running_var.  It is the flagship subset of
scripts/convert_checkpoint.py:export_state_dict (no pooler, no
position_ids buffer: the port's CENet has neither), and raises on any
leaf it cannot place.  ``checkpoint_from_flax`` carries a whole JAX
checkpoint (``serialization.msgpack_restore`` of a ``.msgpack`` the JAX
trainer wrote) over to the port's checkpoint layout, its optax Adam
state included (``optimizer_state_from_flax``).

``shard_state_dict`` cuts a whole state dict (from it or from a
single-device model) to one tensor-parallel rank's shards, in the layout
a ``CENet(tp=)`` reports in its ``shard_dims``; ``gather_state_dict``
puts the ranks' shards back together, for checks.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

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


def _tensor(arr, transpose=False):
  """A tensor of its own (C-ordered) from a numpy array."""
  return torch.from_numpy((arr.T if transpose else arr).copy())


def _by_port_name(tree: Mapping, what: str):
  """Flax params-shaped tree -> {port name: tensor}, kernels transposed;
  a leaf with no port name raises."""
  out = {}
  for path, arr in _flatten(tree).items():
    entry = _param_name(path)
    if entry is None:
      raise KeyError(f"no port name for flax {what} {path}")
    out[entry[0]] = _tensor(arr, entry[1])
  return out


def state_dict_from_flax(params: Mapping, batch_stats: Mapping):
  """Flax {params, batch_stats} (nested dicts of numpy arrays) -> the
  port's CENet state dict of torch tensors."""
  sd = _by_port_name(params, "parameter")
  for path, arr in _flatten(batch_stats).items():
    m = re.match(r"^text_gu_(\w+)/cg/batch_norm/bn/(mean|var)$", path)
    if m is None:
      raise KeyError(f"no port name for flax batch stat {path}")
    base = f"text_GU.{m[1]}.cg.batch_norm"
    sd[f"{base}.running_{m[2]}"] = _tensor(arr)
    sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
  return sd


def _adam_state(opt_state: Mapping):
  """The ``ScaleByAdamState`` (count, mu, nu) of an optax
  ``inject_hyperparams(adam | adamw)`` state, or None for another."""
  inner = opt_state.get("inner_state", {}).get("0", {})
  return inner if "mu" in inner and "nu" in inner else None


def optimizer_state_from_flax(opt_state: Mapping):
  """The JAX trainer's ``optax.inject_hyperparams`` state of Adam / AdamW
  (mmt_tpu/train/optim.py) -> a torch Adam / AdamW state dict keyed by
  the port's parameter names: ``exp_avg`` (mu), ``exp_avg_sq`` (nu), each
  transposed like its kernel, and ``step`` (count) per parameter, and one
  param group holding the names and the last learning rate.
  ``train.checkpoint.optimizer_state_by_position`` puts it in the order
  of an optimizer's parameters."""
  adam = _adam_state(opt_state)
  if adam is None:
    raise ValueError("opt_state is not an optax Adam / AdamW state")
  state = {}
  for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
    for name, t in _by_port_name(tree, f"{key} of").items():
      state.setdefault(name, {})[key] = t
  step = float(np.asarray(adam["count"]))
  for entry in state.values():
    entry["step"] = torch.tensor(step)
  lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
  return {"state": state, "param_groups": [{"params": list(state), "lr": lr}]}


def checkpoint_from_flax(raw: Mapping):
  """A JAX checkpoint tree -> the port's checkpoint layout:
  ``state_dict`` from ``params`` and ``batch_stats``, ``optimizer`` from
  an Adam / AdamW ``opt_state`` (another optimizer's state is left out,
  with a warning), and the counters and config as they are.  The JAX
  ``rng`` key cannot seed a torch generator: the port's dropout generator
  keeps its own state."""
  out = {"state_dict": state_dict_from_flax(raw.get("params", {}),
                                            raw.get("batch_stats", {}))}
  for key in ("epoch", "monitor_best", "n_samples", "n_steps", "config",
              "arch"):
    if key in raw:
      out[key] = raw[key]
  opt_state = raw.get("opt_state")
  if opt_state is not None and _adam_state(opt_state) is not None:
    out["optimizer"] = optimizer_state_from_flax(opt_state)
  elif opt_state is not None:
    logger.warning("JAX checkpoint: its optimizer state is not Adam's; "
                   "not carried over")
  if raw.get("rng") is not None:
    logger.info("JAX checkpoint: its rng key is not carried over; the "
                "dropout generator keeps its own state (jax.random and "
                "torch streams never match)")
  return out


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
