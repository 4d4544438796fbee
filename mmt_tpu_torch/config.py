"""Config system: JSON experiment configs + experiment directory management.

A copy of mmt_tpu/config.py (the port imports nothing of the JAX
package): the transformer hyperparameters the models read (BertParams and
the bert-base-cased text geometry), the txt_agg micro-DSL, the monitor
string, and the experiment ``Config`` with the reference's JSON surface
(parse_config.py:36-201 semantics: save_dir derivation, resume-vs-fresh
logic, config re-serialization).  Field names and defaults are the same;
tests hold them equal.  ``last_checkpoint_path`` finds the newest of the
port's ``.pth`` and the JAX package's ``.msgpack`` checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class BertParams:
  """Transformer hyperparameters (vid_bert_params / text-BERT geometry)."""
  hidden_size: int = 512
  num_hidden_layers: int = 4
  num_attention_heads: int = 4
  intermediate_size: int = 3072
  hidden_act: str = "gelu"
  hidden_dropout_prob: float = 0.1
  attention_probs_dropout_prob: float = 0.1
  max_position_embeddings: int = 32
  type_vocab_size: int = 19
  initializer_range: float = 0.02
  layer_norm_eps: float = 1e-12
  vocab_size: int = 0  # 0 => feature-additive model with no word table

  @classmethod
  def from_dict(cls, d: Dict[str, Any]) -> "BertParams":
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


# bert-base-cased geometry, for the text side.
TEXT_BERT_BASE_CASED = BertParams(
    hidden_size=768,
    num_hidden_layers=12,
    num_attention_heads=12,
    intermediate_size=3072,
    hidden_act="gelu",
    max_position_embeddings=512,
    type_vocab_size=2,
    layer_norm_eps=1e-12,
    vocab_size=28996,
)


@dataclasses.dataclass(frozen=True)
class TxtAggSpec:
  """Parsed txt_agg micro-DSL (model/model.py:137-148).

  'bertftn' / 'bertfrz' / 'bertfrz4' / 'bertftnmxp' ... or one of
  'vlad' | 'mxp' | 'mnp' | 'lstm' | 'moonlight' (the mixture-of-experts
  caption tower of models/moe_text.py).
  """
  kind: str   # 'bert' | 'vlad' | 'mxp' | 'mnp' | 'lstm' | 'moonlight'
  state: Optional[str] = None  # 'ftn' | 'frz' (bert only)
  freeze_until: Optional[int] = None
  post_agg: str = "cls"       # 'cls' | 'mxp' | 'mnp'

  @classmethod
  def parse(cls, txt_agg: str) -> "TxtAggSpec":
    if txt_agg[:4] == "bert":
      z = re.match(r"bert([a-z]{3})(\d*)(\D*)", txt_agg)
      assert z, f"bad txt_agg: {txt_agg}"
      state, until, post = z.groups()
      post_agg = post if post and post != "cls" else "cls"
      assert state in ("ftn", "frz", "scr"), txt_agg
      if state == "ftn":
        assert not until, "bertftn cannot carry a freeze-until layer"
      return cls(kind="bert", state=state,
                 freeze_until=int(until) if until else None,
                 post_agg=post_agg)
    assert txt_agg in ("vlad", "mxp", "mnp", "lstm", "moonlight"), txt_agg
    return cls(kind=txt_agg)


def parse_monitor(monitor: str):
  """'off' | 'given_epoch N' | 'min <metric>' | 'max <metric>'

  (base/base_trainer.py:71-87 semantics).
  """
  if monitor == "off":
    return ("off", None)
  parts = monitor.split()
  if parts[0] == "given_epoch":
    return ("given_epoch", int(parts[1]))
  assert parts[0] in ("min", "max"), monitor
  return (parts[0], parts[1])


# ---------------------------------------------------------------------------
# Experiment config (the object the rest of the framework consumes)
# ---------------------------------------------------------------------------


class Config:
  """Dict-like view over the experiment JSON + derived experiment paths."""

  def __init__(self,
               raw: Dict[str, Any],
               config_path: Optional[pathlib.Path] = None,
               resume: Optional[str] = None,
               only_eval: bool = False,
               save_root: Optional[str] = None):
    self._raw = raw
    self.resume = resume          # checkpoint path to load, or None
    self.only_eval = only_eval
    self.txt_bert_init = None     # CLI --txt_bert_init (set by from_args)

    if "exp_name" in raw:
      self.exper_name = raw["exp_name"]
    else:
      assert config_path is not None
      self.exper_name = pathlib.Path(config_path).stem
      raw["exp_name"] = self.exper_name

    trainer_cfg = raw.setdefault("trainer", {})
    if "save_dir" in trainer_cfg:
      save_dir = pathlib.Path(trainer_cfg["save_dir"])
    else:
      root = pathlib.Path(save_root) if save_root else pathlib.Path.cwd() / "exps"
      save_dir = root / self.exper_name
      trainer_cfg["save_dir"] = str(save_dir)
    self.save_dir = save_dir
    self.log_dir = save_dir
    self.web_dirs = [save_dir / "visualisations"]

  # -- dict-like access ----------------------------------------------------
  def __getitem__(self, name):
    return self._raw[name]

  def __contains__(self, name):
    return name in self._raw

  def get(self, name, default=None):
    return self._raw.get(name, default)

  @property
  def raw(self) -> Dict[str, Any]:
    return self._raw

  # -- typed views ---------------------------------------------------------
  @property
  def arch_args(self) -> Dict[str, Any]:
    return self._raw["arch"]["args"]

  @property
  def vid_bert_params(self) -> BertParams:
    return BertParams.from_dict(self.arch_args["vid_bert_params"])

  @property
  def seed(self) -> int:
    return int(self._raw.get("seed", 0))

  @property
  def cross_seed(self) -> int:
    return int(self._raw.get("cross_seed", 0))

  # -- experiment dir ------------------------------------------------------
  def prepare_dirs(self) -> None:
    self.save_dir.mkdir(parents=True, exist_ok=True)
    for d in self.web_dirs:
      d.mkdir(parents=True, exist_ok=True)

  def dump(self) -> None:
    """Re-serialize the effective config into the experiment dir."""
    with open(self.save_dir / "config.json", "w") as f:
      json.dump(self._raw, f, indent=4, sort_keys=False)


def last_checkpoint_path(exp_dir) -> Optional[str]:
  """Highest checkpoint-epoch<N> in exp_dir (utils/util.py:71-82
  semantics); shared with the checkpoint module."""
  from mmt_tpu_torch.train.checkpoint import last_checkpoint
  return last_checkpoint(exp_dir)


def from_args(args, primary: bool = True) -> Config:
  """Build a Config from CLI args (parse_config.py:36-136 semantics).

  ``primary=False`` (the other ranks of a data-parallel run) skips the
  config's re-dump: every rank derives the same config, and concurrent
  writes of the one config.json would race."""
  if getattr(args, "resume", None):
    assert getattr(args, "config", None) is None, (
        "If resuming an experiment then no config should be provided")
    assert getattr(args, "load_checkpoint", None) is None, (
        "If resuming an experiment then no checkpoint should be provided")
    exp_dir = pathlib.Path(args.resume)
    if exp_dir.is_file():
      # A checkpoint named explicitly.
      resume, exp_dir = str(exp_dir), exp_dir.parent
    else:
      resume = last_checkpoint_path(exp_dir)
    cfg_fname = exp_dir / "config.json"
  else:
    assert getattr(args, "config", None) is not None, (
        "Config file must be specified")
    cfg_fname = pathlib.Path(args.config)
    resume = getattr(args, "load_checkpoint", None) or None

  with open(cfg_fname) as f:
    raw = json.load(f)

  cfg = Config(raw,
               config_path=cfg_fname,
               resume=resume,
               only_eval=bool(getattr(args, "only_eval", False)))
  cfg.txt_bert_init = getattr(args, "txt_bert_init", None)
  cfg.prepare_dirs()
  if primary:
    cfg.dump()
  return cfg


def load(path) -> Config:
  """Load a config file without CLI plumbing (for tests / notebooks)."""
  path = pathlib.Path(path)
  with open(path) as f:
    raw = json.load(f)
  return Config(raw, config_path=path)
