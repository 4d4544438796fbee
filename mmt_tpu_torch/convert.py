"""Carry the JAX package's CENet parameters over to the port.

``state_dict_from_flax`` maps the flax tree (as nested dicts of numpy
arrays) onto the port's state-dict names, which are the reference's:
Dense kernels [in, out] become Linear weights [out, in], LayerNorm
scale/bias become weight/bias, BatchNorm batch_stats mean/var become
running_mean/running_var, flax's per-gate LSTM kernels fuse into
torch.nn.LSTM's tensors.  It mirrors
scripts/convert_checkpoint.py:export_state_dict for every CENet switch
(no pooler, no position_ids buffer: the port's CENet has neither), and
raises on any leaf it cannot place.  ``checkpoint_from_flax`` carries a whole JAX
checkpoint (``serialization.msgpack_restore`` of a ``.msgpack`` the JAX
trainer wrote) over to the port's checkpoint layout, its optax Adam or
Ranger state included (``optimizer_state_from_flax``).

``module_state_dict_from_flax`` does the same for one unit of
mmt_tpu/models/components.py on its own (a ContextGating, a
MimicCEGatedEmbeddingUnit, a GatedEmbeddingUnit, ...: Dense layers and
TorchBatchNorms) onto the port's module of the same name.

``shard_state_dict`` cuts a whole state dict (from it or from a
single-device model) to one tensor-parallel rank's shards, in the layout
a ``CENet(tp=)`` reports in its ``shard_dims``; ``gather_state_dict``
puts the ranks' shards back together (the checkpoints of a tensor-
parallel run, and checks).  ``shard_optimizer_state`` and
``gather_optimizer_state`` do the same to an optimizer's state (Adam's
and AdamW's moments, Ranger's slow buffer), so that a checkpoint has one
format for every layout.
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
  """Flax params path -> (torch name, transpose), or None (the LSTM's
  per-gate leaves are fused by ``_by_port_name``)."""
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
  m = re.match(r"^(.*)/bn/(scale|bias)$", path)
  if m and _bn_name(m[1]):
    return f"{_bn_name(m[1])}.{_LEAF[m[2]]}", False
  m = re.match(r"^(video_dim_reduce|text_gu|video_gu|moe_fc_txt|moe_fc_vid)"
               r"_(\w+?)/((?:cg/)?fc/)?(kernel|bias)$", path)
  if m:
    sub = (m[3] or "").replace("/", ".")
    return f"{_MODULE[m[1]]}.{m[2]}.{sub}{_LEAF[m[4]]}", m[4] == "kernel"
  m = re.match(r"^([gf]_reason_[12]|text_pooling/fc)/(kernel|bias)$", path)
  if m:
    return (f"{m[1].replace('/', '.')}.{_LEAF[m[2]]}", m[2] == "kernel")
  m = re.match(r"^text_pooling/(clusters2?)$", path)
  if m:
    return f"text_pooling.{m[1]}", False
  if path == "word_embeddings/word_embeddings":
    return "word_embeddings.word_embeddings.weight", False
  return None


# Flax module prefix -> the port's ModuleDict of per-modality holders.
_MODULE = {"video_dim_reduce": "video_dim_reduce", "text_gu": "text_GU",
           "video_gu": "video_GU", "moe_fc_txt": "moe_fc_txt",
           "moe_fc_vid": "moe_fc_vid"}
_LSTM_RE = re.compile(
    r"^text_pooling/OptimizedLSTMCell_(\d+)/([ih])([ifgo])/(kernel|bias)$")


def _bn_name(prefix: str):
  """A flax BatchNorm module path (without ``/bn``) -> the port's
  BatchNorm1d holder, or None."""
  m = re.match(r"^(text|video)_gu_(\w+)/cg/(batch_norm2?)$", prefix)
  if m and (m[1] == "video" or m[3] == "batch_norm"):
    return f"{m[1]}_GU.{m[2]}.cg.{m[3]}"
  if prefix == "text_pooling/batch_norm":
    return "text_pooling.batch_norm"
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


def _fused_lstm(gates: Dict, ih_bias: bool):
  """flax OptimizedLSTMCell leaves {(layer, side + gate, leaf): array} ->
  torch.nn.LSTM's fused tensors (gate rows i, f, g, o; the inverse of
  scripts/convert_checkpoint.py:_split_lstm_tensors): the input-side
  kernels become ``weight_ih_l<l>``, the hidden-side ones ``weight_hh_l<l>``
  and their biases ``bias_hh_l<l>``; ``bias_ih_l<l>`` (zeros: flax has
  one bias a gate) only with ``ih_bias``."""
  out = {}
  for layer in sorted({key[0] for key in gates}):
    base = f"text_pooling.lstm.{{}}_l{layer}"
    for side in ("i", "h"):
      out[base.format(f"weight_{side}h")] = torch.from_numpy(np.concatenate(
          [gates[(layer, side + g, "kernel")].T for g in "ifgo"]).copy())
    bias = torch.from_numpy(np.concatenate(
        [gates[(layer, "h" + g, "bias")] for g in "ifgo"]).copy())
    out[base.format("bias_hh")] = bias
    if ih_bias:
      out[base.format("bias_ih")] = torch.zeros_like(bias)
  return out


def _by_port_name(tree: Mapping, what: str, ih_bias: bool = True):
  """Flax params-shaped tree -> {port name: tensor}, kernels transposed,
  the LSTM's gates fused (``_fused_lstm``); a leaf with no port name
  raises."""
  out, gates = {}, {}
  for path, arr in _flatten(tree).items():
    m = _LSTM_RE.match(path)
    if m:
      gates[(m[1], m[2] + m[3], m[4])] = arr
      continue
    entry = _param_name(path)
    if entry is None:
      raise KeyError(f"no port name for flax {what} {path}")
    out[entry[0]] = _tensor(arr, entry[1])
  out.update(_fused_lstm(gates, ih_bias))
  return out


def state_dict_from_flax(params: Mapping, batch_stats: Mapping):
  """Flax {params, batch_stats} (nested dicts of numpy arrays) -> the
  port's CENet state dict of torch tensors."""
  sd = _by_port_name(params, "parameter")
  for path, arr in _flatten(batch_stats).items():
    m = re.match(r"^(.*)/bn/(mean|var)$", path)
    base = _bn_name(m[1]) if m else None
    if base is None:
      raise KeyError(f"no port name for flax batch stat {path}")
    sd[f"{base}.running_{m[2]}"] = _tensor(arr)
    sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
  return sd


# A components.py unit's leaf -> (the port's leaf, transposed).
_UNIT_LEAF = {"kernel": ("weight", True), "scale": ("weight", False),
              "bias": ("bias", False), "mean": ("running_mean", False),
              "var": ("running_var", False)}


def module_state_dict_from_flax(params: Mapping, batch_stats: Mapping = None):
  """A standalone unit's flax {params, batch_stats} -> the state dict of
  the port's module of the same name: each path's ``/`` becomes ``.``,
  TorchBatchNorm's inner ``bn`` level goes, Dense kernels become Linear
  weights, BatchNorm scale / mean / var weight / running_mean /
  running_var.  A leaf of another kind raises."""
  sd = {}
  for path, arr in {**_flatten(params), **_flatten(batch_stats or {})}.items():
    *mods, leaf = [p for p in path.split("/") if p != "bn"]
    if leaf not in _UNIT_LEAF:
      raise KeyError(f"no port name for flax leaf {path}")
    name, transpose = _UNIT_LEAF[leaf]
    sd[".".join([*mods, name])] = _tensor(arr, transpose)
    if leaf == "mean":
      sd[".".join([*mods, "num_batches_tracked"])] = torch.tensor(
          0, dtype=torch.int64)
  return sd


def _moment_state(opt_state: Mapping):
  """The moments of an optax ``inject_hyperparams`` state: the
  ``ScaleByAdamState`` (count, mu, nu) of Adam / AdamW or the
  ``RangerState`` (count, mu, nu, slow), also one level down in the chain
  a freeze mask adds (``chain(tx, masked(set_to_zero))``); None for
  another optimizer's."""
  node = opt_state.get("inner_state")
  while isinstance(node, Mapping):
    if "mu" in node and "nu" in node:
      return node
    node = node.get("0")
  return None


# RangerState / ScaleByAdamState field -> the port's optimizer state key.
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "slow": "slow_buffer"}


def optimizer_state_from_flax(opt_state: Mapping):
  """The JAX trainer's ``optax.inject_hyperparams`` state of Adam / AdamW
  or Ranger (mmt_tpu/train/optim.py), with or without a freeze mask -> a
  torch state dict keyed by the port's parameter names: ``exp_avg`` (mu),
  ``exp_avg_sq`` (nu) and, for Ranger, ``slow_buffer`` (slow), each
  transposed like its kernel (the LSTM's fused), and ``step`` (count) per
  parameter, and one param group holding the names and the last learning
  rate.  A masked state holds the frozen leaves' moments too: they are
  dropped where the state is put in an optimizer's order
  (``train.checkpoint.optimizer_state_by_position``)."""
  moments = _moment_state(opt_state)
  if moments is None:
    raise ValueError("opt_state is not an optax Adam / AdamW / Ranger state")
  state = {}
  for field, key in _MOMENTS.items():
    if field in moments:
      for name, t in _by_port_name(moments[field], f"{key} of",
                                   ih_bias=False).items():
        state.setdefault(name, {})[key] = t
  step = float(np.asarray(moments["count"]))
  for entry in state.values():
    entry["step"] = torch.tensor(step)
  lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
  return {"state": state, "param_groups": [{"params": list(state), "lr": lr}]}


def checkpoint_from_flax(raw: Mapping):
  """A JAX checkpoint tree -> the port's checkpoint layout:
  ``state_dict`` from ``params`` and ``batch_stats``, ``optimizer`` from
  an Adam / AdamW / Ranger ``opt_state`` (another optimizer's state is
  left out, with a warning), and the counters and config as they are.
  The JAX ``rng`` key cannot seed a torch generator: the port's dropout
  generator keeps its own state."""
  out = {"state_dict": state_dict_from_flax(raw.get("params", {}),
                                            raw.get("batch_stats", {}))}
  for key in ("epoch", "monitor_best", "n_samples", "n_steps", "config",
              "arch"):
    if key in raw:
      out[key] = raw[key]
  opt_state = raw.get("opt_state")
  if opt_state is not None and _moment_state(opt_state) is not None:
    out["optimizer"] = optimizer_state_from_flax(opt_state)
  elif opt_state is not None:
    logger.warning("JAX checkpoint: its optimizer state is not Adam's or "
                   "Ranger's; not carried over")
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
    if not isinstance(t, torch.Tensor):
      out[name] = t
      continue
    t = t.detach().cpu()
    if name in dims:
      parts = [torch.empty_like(t) for _ in range(tp.size)]
      dist.all_gather(parts, t.contiguous(), group=tp.group)
      t = torch.cat(parts, dims[name])
    out[name] = t
  return out


def _moment_dims(entry, name, dims):
  """{state key: dim} of one parameter's optimizer state ``entry``: each
  tensor of at least one dim (a moment or slow buffer of the parameter's
  shape) splits as the parameter ``name`` does; the step counts do not."""
  if name not in dims:
    return {}
  return {k: dims[name] for k, v in entry.items()
          if isinstance(v, torch.Tensor) and v.dim() > 0}


def shard_optimizer_state(state, names, tp, dims):
  """An optimizer state dict keyed by position (``optimizer.state_dict()``'s
  layout, the moments at the whole parameters' shapes) -> this rank's
  (``tp``): the moments of the parameter at position i (``names[i]``)
  split as ``dims`` splits it, the rest as it is."""
  return {**state, "state": {
      i: shard_state_dict(entry, tp, _moment_dims(entry, names[i], dims))
      for i, entry in state["state"].items()}}


def gather_optimizer_state(state, names, tp, dims):
  """The ranks' optimizer states (keyed by position, as
  ``shard_optimizer_state`` takes them) put back together as CPU tensors,
  the single-process layout.  A collective: every rank of ``tp`` calls
  it."""
  return {**state, "state": {
      i: gather_state_dict(entry, tp, _moment_dims(entry, names[i], dims))
      for i, entry in state["state"].items()}}
