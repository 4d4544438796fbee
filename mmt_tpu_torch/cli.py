"""Training entry point of the port.

Port of train.py, the same surface:

  python -m mmt_tpu_torch.train --config configs/eccv20/X.json
      [--resume EXPDIR | --resume EXPDIR/checkpoint-epochN.msgpack]
      [--load_checkpoint PTH_OR_MSGPACK] [--txt_bert_init P] [--only_eval]
      [--device cuda|cpu] [-v]

Builds tokenizer -> data loaders -> model -> loss -> optimizer ->
schedule -> visualizer -> trainer, then trains and runs the final eval,
writing the JAX CLI's artifacts (``.pth`` checkpoints in place of
``.msgpack``).  The JAX CLI's ``.msgpack`` checkpoints and inits are read
too: ``--resume EXPDIR`` takes the highest-epoch checkpoint of either
suffix (the ``.pth`` at equal epochs), and the purge of stale
checkpoints deletes only ``.pth`` files.  ``--device`` is a torch device and defaults to ``cuda``; without a
card, pass ``--device cpu``: the port never falls back to the CPU by
itself.

Data parallelism over several processes takes the JAX CLI's environment
interface: each process runs this CLI with MMT_TPU_COORDINATOR
(host:port of rank 0's rendezvous), MMT_TPU_NUM_PROCESSES and
MMT_TPU_PROCESS_ID set; the group is joined before any other device use
(``parallel.maybe_initialize_distributed``: gloo on the CPU, NCCL with a
card per rank, gloo when ranks share a card), rank r runs on cuda:r %
cards, and only rank 0 writes config.json, log.txt and the experiment's
files (rank r logs to log.p<r>.txt).  With ``trainer.model_parallel`` M
(or MMT_TPU_MODEL_PARALLEL) the processes are N / M data ranks of M
model ranks each (tensor parallelism within a model group, one host),
as the JAX CLI's 2-D mesh; the checkpoints keep the one-process format.

The JAX CLI's kernel switches: MMT_TPU_PALLAS_FFN=0 runs the FFN blocks'
plain PyTorch versions on the card for the whole run,
MMT_TPU_PALLAS_SIMILARITY=0 the similarity's (``ops.environment_switches``;
the other family keeps its kernels, and the fused ranks always do).
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np

from mmt_tpu_torch import ops

logger = logging.getLogger(__name__)

# Where the pretrained text-BERT init is looked for when none is named:
# python -m mmt_tpu_torch.hf_bert's default output, then the JAX
# package's (scripts/convert_hf_bert.py, as in train.py).
_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TXT_BERT_INIT_DEFAULTS = (os.path.join(_DATA, "txt_bert_init.pth"),
                          os.path.join(_DATA, "txt_bert_init.msgpack"))


def build_data_loaders(config, expert_dims, tokenizer):
  from mmt_tpu_torch.registry import build
  import mmt_tpu_torch.data.loader  # noqa: F401 (registers ExpertDataLoader)

  loaded_data = {}
  loaders = {}
  for key, training in (("train_sets", True), ("continuous_eval_sets", False),
                        ("final_eval_sets", False)):
    loaders[key] = [
        build("data_loader", spec, raw_input_dims=expert_dims,
              training=training, tokenizer=tokenizer, loaded_data=loaded_data,
              cross_seed=config.cross_seed)
        for spec in config.get(key, [])
    ]
  return loaders


def resolve_txt_bert_init(config, arch_value, txt_agg, custom_geometry=False):
  """Locate pretrained text-BERT init weights for bertftn / bertfrz runs
  (train.py:resolve_txt_bert_init).

  The reference builds only those text towers from pretrained
  bert-base-cased (model/model.py:150-162); the converted weights are
  resolved in priority order: CLI ``--txt_bert_init`` >
  ``MMT_TPU_TXT_BERT_INIT`` > arch.args ``txt_bert_init`` > the default
  assets ``TXT_BERT_INIT_DEFAULTS`` (if present, and only at the stock
  geometry).  For a non-pretrained tower a CLI / config request raises
  (it contradicts the architecture) while an ambient environment variable
  is ignored with a log line.  Returns a path or None; with none found
  (and no resume) it warns that the text tower starts from random
  weights."""
  from mmt_tpu_torch.config import TxtAggSpec

  spec = TxtAggSpec.parse(txt_agg) if txt_agg[:4] == "bert" else None
  cli_value = getattr(config, "txt_bert_init", None)
  env_value = os.environ.get("MMT_TPU_TXT_BERT_INIT")
  if spec is None or spec.state not in ("ftn", "frz"):
    if cli_value or arch_value:
      raise ValueError(
          f"txt_bert_init={cli_value or arch_value!r} conflicts with "
          f"txt_agg={txt_agg!r}: only bertftn/bertfrz towers start from "
          "pretrained weights (model/model.py:150-162)")
    if env_value:
      logger.info("MMT_TPU_TXT_BERT_INIT ignored: txt_agg=%s stays "
                  "randomly initialized, as in the reference", txt_agg)
    return None
  explicit = cli_value or env_value or arch_value
  if explicit:
    if not os.path.isfile(explicit):
      raise FileNotFoundError(f"txt_bert_init not found: {explicit}")
    return explicit
  if custom_geometry:
    # The default assets are bert-base-cased; a model with an overridden
    # text_bert_geometry cannot load them: only a named path applies.
    return None
  for default in TXT_BERT_INIT_DEFAULTS:
    if os.path.isfile(default):
      return default
  if config.resume is None:
    logger.warning(
        "txt_agg=%s: no pretrained text-BERT weights found — txt_bert is "
        "RANDOMLY initialized (the reference always starts from pretrained "
        "bert-base-cased).  Convert them once with python -m "
        "mmt_tpu_torch.hf_bert (default output %s) or pass "
        "--txt_bert_init.", txt_agg, TXT_BERT_INIT_DEFAULTS[0])
  return None


def _is_custom_text_geometry(geom):
  """True when a text_bert_geometry override departs from bert-base-cased
  (train.py:_is_custom_text_geometry)."""
  if not geom:
    return False
  import dataclasses
  from mmt_tpu_torch.config import TEXT_BERT_BASE_CASED
  stock = dataclasses.asdict(TEXT_BERT_BASE_CASED)
  return any(stock.get(k) != v for k, v in dict(geom).items())


def freeze_parameters(model, txt_agg: str, txt_inp: str):
  """Turn off ``requires_grad`` of the parameters a run freezes and
  return their names (train.py:frozen_param_mask, the reference's
  model/model.py:164-193): ``bertfrz`` the whole text encoder,
  ``bertfrz<N>`` its layers 0..N-1, and a ``*frz`` txt_inp (bertfrz /
  wo2vfrz / grvlfrz) the text tower's embeddings and the word-vector
  table.  Gradients still flow through frozen layers to the trainable
  ones below them.  The JAX package zeroes the frozen leaves' updates
  after the optimizer (``optax.masked(set_to_zero)``); here they hold no
  gradient and stay out of the optimizer, so their update is zero,
  decoupled weight decay included."""
  from mmt_tpu_torch.config import TxtAggSpec

  spec = TxtAggSpec.parse(txt_agg) if txt_agg[:4] == "bert" else None
  prefixes = []
  if spec is not None and spec.state == "frz":
    if spec.freeze_until is None:
      prefixes.append("txt_bert.encoder.")
    else:
      prefixes += [f"txt_bert.encoder.layer.{i}."
                   for i in range(spec.freeze_until)]
  if txt_inp.endswith("frz"):
    prefixes += ["txt_bert.embeddings.", "word_embeddings."]
  names = []
  for name, param in model.named_parameters():
    if name.startswith(tuple(prefixes)):
      param.requires_grad_(False)
      names.append(name)
  if names:
    logger.info("Frozen (txt_agg=%s, txt_inp=%s): %d parameters", txt_agg,
                txt_inp, len(names))
  return names


def build_trainer(config, device="cuda", dp=None):
  """Construct the fully-wired Trainer for ``config`` on ``device``
  (model, loaders, freeze mask, optimizer over the trainable parameters,
  schedule) without running it; ``dp`` is the group of processes
  (``parallel.maybe_initialize_distributed``), None in one process.
  With ``model_parallel`` M > 1 (the trainer's config, or
  MMT_TPU_MODEL_PARALLEL) the processes are laid out as N / M data ranks
  of M model ranks (``trainer.parallel_layout``) and the model is split
  over the rank's model group."""
  from mmt_tpu_torch.experts import compute_dims
  from mmt_tpu_torch.models.cenet import CENet, cenet_kwargs_from_arch_args
  from mmt_tpu_torch.registry import build, get
  from mmt_tpu_torch.tokenization import create_tokenizer
  from mmt_tpu_torch.train.optim import build_optimizer, step_lr
  from mmt_tpu_torch.train.trainer import (Trainer, check_device,
                                           model_parallel, parallel_layout)
  import mmt_tpu_torch.train.losses    # noqa: F401 (registry)
  import mmt_tpu_torch.train.metrics   # noqa: F401 (registry)
  import mmt_tpu_torch.utils.visualizer  # noqa: F401 (registry)

  device = check_device(device)
  data, tp = parallel_layout(dp, model_parallel(config["trainer"]))
  expert_dims = compute_dims(config.raw)
  logger.debug("experts: %s", expert_dims)

  # Seeds (train.py:53-59): data-pipeline randomness is host-side numpy;
  # model randomness flows through the trainer's torch.Generator.
  seed = config.seed
  random.seed(seed)
  np.random.seed(seed)

  arch_args = dict(config.arch_args)
  tokenizer = create_tokenizer(arch_args.get("txt_inp", "bertftn"))
  data_loaders = build_data_loaders(config, expert_dims, tokenizer)

  model_kwargs, cfg_txt_bert_init = cenet_kwargs_from_arch_args(
      arch_args, tokenizer)
  txt_bert_init = resolve_txt_bert_init(
      config, cfg_txt_bert_init, arch_args.get("txt_agg", "bertftn"),
      custom_geometry=_is_custom_text_geometry(
          model_kwargs.get("text_bert_geometry")))
  model = CENet(expert_dims=expert_dims, device=device, tp=tp,
                **model_kwargs)

  loss_fn = build("loss", config["loss"])
  metrics = [(name, get("metric", name)) for name in config["metrics"]]
  freeze_parameters(model, arch_args.get("txt_agg", ""),
                    arch_args.get("txt_inp", ""))
  optimizer, base_lr = build_optimizer(
      config["optimizer"], [p for p in model.parameters() if p.requires_grad])
  sched_args = config.get("lr_scheduler", {"args": {}}).get("args", {})
  lr_schedule = step_lr(base_lr, sched_args.get("step_size", 1),
                        sched_args.get("gamma", 1.0))

  visualizer = None
  if "visualizer" in config.raw:
    visualizer = build("visualizer", config["visualizer"],
                       exp_name=config.exper_name, web_dirs=config.web_dirs)

  cfg_trainer = config["trainer"]
  return Trainer(
      model=model, loss_fn=loss_fn, metrics=metrics, optimizer=optimizer,
      config=config, data_loaders=data_loaders,
      lr_schedule=lr_schedule, visualizer=visualizer,
      skip_first_n_saves=cfg_trainer.get("skip_first_n_saves", 0),
      include_optim_in_ckpts=cfg_trainer.get("include_optim_in_ckpts",
                                             False),
      expert_dims=expert_dims,
      num_keep_ckpts=cfg_trainer.get("num_keep_ckpts", 1),
      tokenizer=tokenizer,
      warmup_iterations=cfg_trainer.get("warmup_iterations", -1),
      device=device, txt_bert_init=txt_bert_init, dp=data, group=dp)


def train(config, device="cuda", dp=None):
  trainer = build_trainer(config, device=device, dp=dp)
  if not config.only_eval:
    trainer.train()
  trainer.evaluate()
  return trainer


def main(argv=None):
  parser = argparse.ArgumentParser(description="mmt_tpu_torch trainer")
  parser.add_argument("--config", default=None, type=str,
                      help="config file path")
  parser.add_argument("--resume", default=None, type=str,
                      help="path to the experiment dir to resume (its "
                           "newest .pth or JAX .msgpack checkpoint), or to "
                           "one of its checkpoints")
  parser.add_argument("--load_checkpoint", default=None, type=str,
                      help="checkpoint (.pth, or the JAX CLI's .msgpack) "
                           "path for a warm start")
  parser.add_argument("--txt_bert_init", default=None, type=str,
                      help="converted pretrained text-BERT weights "
                           "(python -m mmt_tpu_torch.hf_bert, or the JAX "
                           "package's scripts/convert_hf_bert.py msgpack); "
                           "defaults to data/txt_bert_init.pth, then "
                           "data/txt_bert_init.msgpack, when present")
  parser.add_argument("--device", default="cuda", type=str,
                      help="torch device (default cuda; cpu runs the plain "
                           "PyTorch versions of the kernels)")
  parser.add_argument("--only_eval", action="store_true",
                      help="skip training; evaluate only")
  parser.add_argument("-v", "--verbose", action="store_true")
  args = parser.parse_args(argv)

  from mmt_tpu_torch import config as config_lib
  from mmt_tpu_torch.parallel import mesh as mesh_lib
  from mmt_tpu_torch.train.trainer import check_device
  # A multi-process run joins its group before any other device use, and
  # the rank gates the file writes below (config dump, log file).
  check_device(args.device)
  dp = mesh_lib.maybe_initialize_distributed(args.device)
  rank = 0 if dp is None else dp.rank
  device = check_device(mesh_lib.rank_device(args.device, rank))
  config = config_lib.from_args(args, primary=rank == 0)

  level = logging.DEBUG if args.verbose else logging.INFO
  # force=True so a second experiment in the same process re-points the
  # log file at its own exp dir (parse_config.py:103-117 behavior).  The
  # other ranks log to files of their own (log.txt is rank 0's).
  log_name = "log.txt" if rank == 0 else f"log.p{rank}.txt"
  logging.basicConfig(
      level=os.environ.get("LOGLEVEL", level),
      format="%(message)s",
      force=True,
      handlers=[logging.FileHandler(config.save_dir / log_name),
                logging.StreamHandler()])
  logger.info("Experiment directory: %s", config.save_dir)
  if dp is not None:
    logger.info("distributed: rank %d of %d over %s on %s", dp.rank, dp.size,
                dp.backend, device)

  epochs = config["trainer"]["epochs"]
  save_period = config["trainer"].get("save_period", 1)
  assert epochs >= save_period, (
      f"epochs ({epochs}) must be >= save_period ({save_period}), "
      "otherwise no checkpoint would ever be written")

  # MMT_TPU_PALLAS_FFN=0 / MMT_TPU_PALLAS_SIMILARITY=0 run that family's
  # plain versions for the whole run (ops.environment_switches).
  with ops.environment_switches():
    return train(config, device=device, dp=dp)
