"""Training runtime: epoch loop, eval, checkpoints, logs, on one device
or over a data-parallel group of processes.

Port of mmt_tpu/train/trainer.py (base/base_trainer.py:39-464 +
trainer/trainer.py:55-493 semantics):

* each step is ``train.step.train_step`` (forward, 'avg' similarity,
  loss, backward, optimizer) with the dropout masks drawn from one
  ``torch.Generator`` seeded from ``config.seed``, whose state the
  checkpoints carry;
* eval embeds under ``torch.inference_mode()`` and ranks on the device,
  from the [Q, V] similarity matrix or, at ``fused_eval_from_videos``
  videos and more, straight from the embeddings (train/metrics.py);
* batches reach the device through ``data.loader.device_prefetch``
  (pinned memory, a side stream, 2 batches ahead);
* epoch-0 eval-only baseline, curriculum train-set selection by
  ``until_epoch``, ``max_samples_per_epoch`` caps, monitor / early-stop /
  best-checkpoint, atomic checkpoint saves + stale purge, SIGTERM
  preemption checkpoint, perf log and TensorBoard scalars (a null writer
  without tensorboardX), final-eval artifacts (sims .npy, challenge CSV,
  HTML ranking pages, exp_results.json + completion flag).

The pretrained text-tower init (``txt_bert_init``) is merged strictly
into the text tower, and a word-embedding tokenizer's vectors are copied
into the word table, before any resume or warm start, so a checkpoint
wins over both.  The optimizer's state (Adam's, AdamW's, Ranger's with
its slow buffer) goes through the checkpoints with
``include_optim_in_ckpts``.

Data parallelism (the JAX trainer's data mesh, mmt_tpu/train/trainer.py:
116-118, 221-234, 745-787, 918-1006), over the group ``dp`` (a
``parallel.DataParallel``, as ``parallel.maybe_initialize_distributed``
returns it): every process runs the same program in lockstep from the
same seed and loaders (each at 0 workers; a loader with workers
raises); a train step takes the rank's rows of each global batch
(``parallel.mesh.local_rows``) through ``train_step(dp=)``: global-batch
negatives, global BatchNorm moments, summed gradients.  The eval pads
each batch to a multiple of the group (``parallel.mesh.
pad_batch_to_multiple``), embeds the rank's rows and gathers them, so
every rank holds the whole embeddings and takes the same decisions; the
fused eval embeds to host memory (``_get_embeddings(to_host=True)``) and
counts candidate shards (``fused_retrieval_metrics(dp=)``).  A train
batch size that the group does not divide runs the whole run replicated,
with a warning.  Only the primary (rank 0) writes: checkpoints, purges,
TensorBoard, the perf log, the visualizer, the final-eval artifacts;
barriers bracket the final eval; every rank reads on resume.

Tensor parallelism (``trainer.model_parallel`` = M, or
MMT_TPU_MODEL_PARALLEL, as the JAX trainer reads it: mmt_tpu/train/
trainer.py:144-157, 221-258) over the process group laid out in 2-D by
``parallel_layout`` (``parallel.mesh.data_mesh``): N / M data ranks of M
model ranks each.  The model is a ``CENet(tp=)`` on the rank's model
group; its weights are the single-device model's from the config's seed,
split (``CENet.init_weights``).  The data group takes the rows (train
steps, eval, the fused eval's candidate shards) as above; the gradients
are summed over it only, since under Megatron's f and g every model rank
already holds the whole gradient of each replicated parameter.  The
checkpoints have the single-process format: the parameters and the
optimizer's moments are gathered from the model group before rank 0
writes, and every read (resume, warm start, the text-tower init) is cut
to the rank's shards.  A request that cannot be honored raises the JAX
trainer's ValueError (one process, a world or a train batch that does not
divide); the replicated fallback above is for M = 1 only.

Debug and observability switches, each a ``trainer`` config key or an
environment variable, as the JAX trainer reads them (mmt_tpu/train/
trainer.py:185-194): ``debug_nans`` / MMT_TPU_DEBUG_NANS raises
FloatingPointError at the first NaN of ``train()`` and ``evaluate()``
(``nan_trap``; jax_debug_nans in the JAX package), ``profile_dir`` /
MMT_TPU_PROFILE traces the first trained epoch, ``sanity_checks`` /
MMT_TPU_SANITY_CHECKS validates the first batch of each epoch.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import logging
import math
import os
import pathlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from mmt_tpu_torch import convert
from mmt_tpu_torch.config import parse_monitor
from mmt_tpu_torch.data import loader as loader_lib
from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.train import checkpoint as ckpt_lib
from mmt_tpu_torch.train import metrics as metrics_lib
from mmt_tpu_torch.train.optim import linear_warmup
from mmt_tpu_torch.train.step import train_step
from mmt_tpu_torch.utils.timing import (AverageMeter, profiler_trace,
                                        spanned, update_perf_log)

logger = logging.getLogger(__name__)

MODEL_BATCH_KEYS = ("token_ids", "query_masks", "features", "features_t",
                    "features_ind", "features_avgpool", "features_maxpool")


def model_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
  """Strip host-only list fields (the analogue of move_dict_to_device's
  tensor filter, trainer/trainer.py:36-52)."""
  return {k: batch[k] for k in MODEL_BATCH_KEYS if k in batch}


def compress_predictions(query_masks: np.ndarray, sims: np.ndarray,
                         topk: int = 10) -> np.ndarray:
  """Top-k ranked video indices per valid query (utils/util.py:37-68)."""
  assert query_masks.ndim == 2 and sims.ndim == 2
  nv, per_vid = query_masks.shape
  nq, nv2 = sims.shape
  assert nv == nv2 and nq == nv * per_vid
  valid = sims[query_masks.flatten().astype(bool)]
  return np.argsort(-valid, axis=1)[:, :topk]


def _json_sanitize(obj):
  """Replace non-finite floats with strings so the output is RFC-8259
  JSON (json.dump would otherwise emit bare `Infinity`/`NaN`)."""
  if isinstance(obj, dict):
    return {k: _json_sanitize(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_json_sanitize(v) for v in obj]
  if isinstance(obj, float) and not math.isfinite(obj):
    return str(obj)
  return obj


def model_parallel(cfg_trainer) -> int:
  """The model axis a run asks for: ``model_parallel`` in the trainer's
  config, else MMT_TPU_MODEL_PARALLEL, else 1."""
  return int(cfg_trainer.get("model_parallel",
                             os.environ.get("MMT_TPU_MODEL_PARALLEL", 1)))


def cannot_honor(mp: int, why: str) -> ValueError:
  """The JAX trainer's error for a model axis it cannot lay out
  (mmt_tpu/train/trainer.py:235-244)."""
  return ValueError(f"model_parallel={mp} was requested but cannot be "
                    f"honored: {why}. Fix the config or unset model_parallel")


def parallel_layout(group, mp: int):
  """(data group, model group) of this rank for a run with model axis
  ``mp`` over the process ``group`` (``parallel.mesh.data_mesh``; an axis
  of size 1 is None).  One process, or a world that ``mp`` does not
  divide, raises ``cannot_honor``."""
  n = 1 if group is None else group.size
  if mp > 1 and n == 1:
    raise cannot_honor(mp, "1 process; tensor parallelism takes one "
                       "process per model rank (MMT_TPU_COORDINATOR, "
                       "MMT_TPU_NUM_PROCESSES, MMT_TPU_PROCESS_ID)")
  if mp > 1 and n % mp:
    raise cannot_honor(mp, f"it does not divide the {n} processes")
  return mesh_lib.data_mesh(group, mp)


def shard_for(model, state_dict):
  """A whole state dict (a checkpoint's, an init's) cut to ``model``'s
  shards when it is split over a model group (``model.tp``); as it is
  otherwise."""
  tp = getattr(model, "tp", None)
  if tp is None:
    return state_dict
  return convert.shard_state_dict(state_dict, tp, model.shard_dims)


def _lockstep_loaders(data_loaders):
  """Raise on a loader with worker threads: in a group every rank must
  assemble the same batches, and workers draw the numpy stream in no
  fixed order."""
  loaders = [e["loader"] for key in ("train_sets", "continuous_eval_sets",
                                     "final_eval_sets")
             for e in data_loaders.get(key, [])]
  if any(getattr(ldr, "num_workers", 0) > 0 for ldr in loaders):
    # ExpertDataLoader sets 0 in a group; a loader built before the group
    # was joined, or by hand, would break the lockstep.
    raise ValueError(
        "data parallel: a loader has num_workers > 0, whose samples draw "
        "from the numpy stream in no fixed order, so the ranks' batches "
        "would differ; build the loaders at num_workers 0 (or after "
        "joining the group)")


def check_device(device) -> torch.device:
  """``device`` as a torch.device; a CUDA device without a card raises
  (the port never falls back to the CPU)."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {device}: no CUDA device here; pass device='cpu' (the "
        "CLI's --device cpu) to run on the CPU")
  return device


def _tensors(obj):
  """The tensors in a module's output (nested tuples, lists, dicts)."""
  if isinstance(obj, torch.Tensor):
    yield obj
  elif isinstance(obj, dict):
    for v in obj.values():
      yield from _tensors(v)
  elif isinstance(obj, (tuple, list)):
    for v in obj:
      yield from _tensors(v)


@contextlib.contextmanager
def nan_trap(model, enabled=True):
  """While open (and ``enabled``), the first NaN raises
  FloatingPointError, as jax_debug_nans does: in the forward a hook on
  every submodule names the module whose output first holds one; in the
  backward ``torch.autograd.detect_anomaly(check_nan=True)`` names the
  function whose gradient first does (the kernels' autograd.Functions
  included).  Values and launches are unchanged; on exit the hooks go and
  the anomaly mode is what it was."""
  if not enabled:
    yield
    return
  names = {}
  for name, module in model.named_modules():
    names.setdefault(module, name or type(model).__name__)

  def check(module, inputs, output):
    for t in _tensors(output):
      if t.is_floating_point() and bool(torch.isnan(t).any()):
        raise FloatingPointError(
            f"debug_nans: NaN in the output of module {names[module]!r} "
            f"({type(module).__name__})")

  handles = [m.register_forward_hook(check) for m in names]
  try:
    with torch.autograd.detect_anomaly(check_nan=True):
      yield
  except RuntimeError as err:
    if "nan values" not in str(err):
      raise
    raise FloatingPointError(f"debug_nans: NaN in the backward: {err}") \
        from err
  finally:
    for h in handles:
      h.remove()


def _nans_trapped(method):
  """``method`` under ``nan_trap(self.model, self.debug_nans)``."""
  @functools.wraps(method)
  def run(self, *args, **kwargs):
    with nan_trap(self.model, self.debug_nans):
      return method(self, *args, **kwargs)
  return run


def _read_async(vals):
  """Start the device->host copy of a stacked loss window: (host tensor,
  event to wait on before reading it, or None)."""
  if not vals.is_cuda:
    return vals, None
  host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
  host.copy_(vals, non_blocking=True)
  done = torch.cuda.Event()
  done.record()
  return host, done


class Trainer:
  """Epoch-loop trainer over ``train.step.train_step``."""

  def __init__(self, model, loss_fn, metrics, optimizer, config,
               data_loaders, lr_schedule, visualizer=None,
               skip_first_n_saves=0, include_optim_in_ckpts=False,
               expert_dims=None, num_keep_ckpts=1, tokenizer=None,
               warmup_iterations=-1, device="cuda", txt_bert_init=None,
               dp=None, group=None):
    """``dp``: the data group (``parallel_layout``'s first); ``group``:
    every process (``dp`` when omitted, as without tensor parallelism).
    A model split over a model group (``CENet(tp=)``) carries it as
    ``model.tp``."""
    self.device = check_device(device)
    # Multi-process topology: every process runs the same program in
    # lockstep (the loaders are deterministic; the eval's metrics come
    # from the gathered embeddings everywhere, so control flow such as
    # early stopping stays in step); only the primary touches the files.
    self.group = group if group is not None else dp
    self.tp = tp = getattr(model, "tp", None)
    self.is_primary = ((self.group is None or self.group.primary)
                       and (tp is None or tp.primary))
    self.model = model
    self.loss_fn = loss_fn
    self.metrics = metrics                      # list of (name, fn)
    self.optimizer = optimizer
    self.config = config
    self.data_loaders = data_loaders
    self.lr_schedule = lr_schedule
    # The fused-vs-matrix eval decision must be the same on every process,
    # so it keys off whether a visualizer was configured; only the primary
    # draws.
    self._want_visualizer = visualizer is not None
    self.visualizer = visualizer if self.is_primary else None
    self.skip_first_n_saves = skip_first_n_saves
    self.include_optim_in_ckpts = include_optim_in_ckpts
    self.num_keep_ckpts = num_keep_ckpts
    self.tokenizer = tokenizer
    self.warmup = linear_warmup(warmup_iterations)
    self.modalities = list(expert_dims.keys()) if expert_dims else []

    cfg_trainer = config["trainer"]
    self.model_parallel = model_parallel(cfg_trainer)
    if self.model_parallel > 1 and (tp is None
                                    or tp.size != self.model_parallel):
      raise cannot_honor(
          self.model_parallel,
          f"the model is split over {1 if tp is None else tp.size} "
          "rank(s); build it on parallel_layout's model group")
    self.epochs = cfg_trainer["epochs"]
    self.save_period = cfg_trainer.get("save_period", 1)
    self.max_samples_per_epoch = cfg_trainer.get("max_samples_per_epoch",
                                                 int(1e9))
    monitor = cfg_trainer.get("monitor", "off")
    self.mnt_mode, self.mnt_arg = parse_monitor(monitor)
    if self.mnt_mode in ("min", "max"):
      self.mnt_metric = self.mnt_arg
      self._validate_monitor_metric()
      self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
      self.early_stop = cfg_trainer.get("early_stop", np.inf)
    else:
      self.mnt_best = 0
      self.given_epoch = self.mnt_arg if self.mnt_mode == "given_epoch" else -1

    self.exp_dir = pathlib.Path(config.save_dir)
    self.perf_log_path = self.exp_dir / "perf_log.txt"
    self.timer = AverageMeter()
    self.writer = self._make_writer(config.log_dir)
    from mmt_tpu_torch.utils.hparams import get_hparams_from_config
    self.hparams = get_hparams_from_config(config)

    # Debug and observability switches: a NaN raises (``nan_trap``); a
    # torch.profiler trace of the first trained epoch; batch invariants
    # on the first batch of each epoch, on the host.
    self.debug_nans = bool(cfg_trainer.get("debug_nans")
                           or os.environ.get("MMT_TPU_DEBUG_NANS"))
    if self.debug_nans:
      logger.info("debug_nans enabled")
    self.profile_dir = (cfg_trainer.get("profile_dir")
                        or os.environ.get("MMT_TPU_PROFILE"))
    self.sanity_checks = bool(cfg_trainer.get("sanity_checks")
                              or os.environ.get("MMT_TPU_SANITY_CHECKS"))
    # Eval sets with >= this many videos rank on the device from the
    # embeddings (ops/ranking.py fused path); the [Q, V] similarity
    # matrix is never materialized.  Applies where no sims artifact is
    # required.
    self.fused_eval_from_videos = cfg_trainer.get("fused_eval_from_videos",
                                                  50_000)

    # Preemption-safe checkpointing: SIGTERM triggers an atomic save
    # before exit (the reference has no failure handling; its recovery is
    # manual --resume).
    self._install_preemption_handler()

    # Background checkpoint writes: the device->host snapshot happens
    # inline (the next step updates the parameters in place), the
    # serialization + disk write overlap the next epoch.  trainer.args
    # "async_checkpoint": false restores inline writes.
    self._ckpt_writer = ckpt_lib.AsyncCheckpointWriter(
        async_enabled=bool(cfg_trainer.get("async_checkpoint", True))
        and self.is_primary)

    self.start_epoch = 0
    self.epoch = 0
    self.loaded_epoch = 0
    self.n_samples = 0
    self.n_steps = 0
    self.dp = (self._data_parallel() if tp is None
               else self._tensor_parallel_rows(dp))

    # Weights and the dropout stream from one generator seeded from the
    # config (the JAX package splits one key for both).
    self.generator = torch.Generator(device=self.device).manual_seed(
        config.seed)
    self._init_state()

    if getattr(tokenizer, "weights", None) is not None and hasattr(
        model, "word_embeddings"):
      self._load_word_vectors(tokenizer.weights)
    if txt_bert_init is not None:
      self._load_txt_bert_init(txt_bert_init)

    if config.resume is not None:
      self._resume_checkpoint(config.resume)

  def _data_parallel(self):
    """The group the train steps and evals split their rows over: the
    process group, unless a train batch size does not divide it
    (mmt_tpu/train/trainer.py:221-234): then every rank trains and
    evaluates the whole batches (replicated), and the log says so.
    Either way every rank must assemble the same batches: a loader with
    worker threads raises."""
    group = self.group
    if group is None or group.size == 1:
      return None
    _lockstep_loaders(self.data_loaders)
    sizes = [e.batch_size for e in self.data_loaders.get("train_sets", [])]
    if any(b % group.size for b in sizes):
      logger.warning(
          "data parallel: train batch size %s does not divide the %d "
          "ranks; the whole run trains and evaluates REPLICATED (every "
          "rank the whole batch); set batch_size to a multiple to shard",
          sizes, group.size)
      return None
    logger.info("data parallel: rank %d of %d over %s; train batches %s "
                "split %d ways (global-batch negatives and BatchNorm "
                "moments), the eval's rows gathered", group.rank,
                group.size, group.backend, sizes, group.size)
    return group

  def _tensor_parallel_rows(self, dp):
    """The data group ``dp`` of a tensor-parallel run (None on a 1 x M
    layout: every model rank takes the whole batches).  A train batch
    size the data axis does not divide raises: under tensor parallelism
    there is no replicated fallback (mmt_tpu/train/trainer.py:235-244)."""
    _lockstep_loaders(self.data_loaders)
    sizes = [e.batch_size for e in self.data_loaders.get("train_sets", [])]
    n = 1 if dp is None else dp.size
    if any(b % n for b in sizes):
      raise cannot_honor(self.model_parallel,
                         f"train batch size {sizes} does not divide the "
                         f"{n}-way data axis (processes / model_parallel)")
    logger.info("tensor parallel: model rank %d of %d, data rank %d of %d "
                "over %s; train batches %s split %d ways, the gradients "
                "summed over the data axis only", self.tp.rank, self.tp.size,
                0 if dp is None else dp.rank, n, self.tp.backend, sizes, n)
    return dp

  def _barrier(self):
    if self.group is not None:
      self.group.barrier()

  # ------------------------------------------------------------------
  def _validate_monitor_metric(self):
    """Fail fast on a monitor key the epoch log will never contain
    (mmt_tpu/train/trainer.py:288-321): '<dataset>/<metric_fn>/<name>'
    for every continuous eval set, or one of the scalar epoch-log keys."""
    scalar_keys = {"epoch", "loss", "learning_rate", "n_samples", "n_steps"}
    if self.mnt_metric in scalar_keys:
      return
    ds_names = {e["dataset"].dataset_name
                for e in self.data_loaders.get("continuous_eval_sets", [])}
    metric_fns = {name for name, _ in self.metrics}
    parts = self.mnt_metric.split("/")
    ok = (len(parts) == 3 and parts[0] in ds_names
          and parts[1] in metric_fns)
    if ok and parts[1] in ("t2v_metrics", "v2t_metrics"):
      ok = parts[2] in {"R1", "R5", "R10", "R50", "MedR", "MeanR",
                        "geometric_mean_R1-R5-R10"}
    if not ok:
      hint = sorted(f"{ds}/{fn}/R1" for ds in ds_names
                    for fn in metric_fns)[:4]
      raise ValueError(
          f"monitor metric {self.mnt_metric!r} will never appear in the "
          f"epoch log (eval sets: {sorted(ds_names)}, metrics: "
          f"{sorted(metric_fns)}); examples of valid keys: {hint} "
          f"or scalar keys {sorted(scalar_keys)}")

  # ------------------------------------------------------------------
  def _install_preemption_handler(self):
    import signal

    self._preempt_requested = False

    def handler(signum, frame):
      # Defer the save to the next step boundary: the train loop checks
      # the flag after every step.
      logger.warning("SIGTERM received: checkpointing at the next step "
                     "boundary")
      self._preempt_requested = True

    try:
      signal.signal(signal.SIGTERM, handler)
    except ValueError:
      pass  # not the main thread (e.g. under some test runners)

  def _maybe_preempt_exit(self, completed_epoch: int):
    """If preemption was requested, checkpoint and exit 143.

    The checkpoint is stamped with the last COMPLETED epoch: a mid-epoch
    save that claimed the current epoch would make restart skip the rest
    of that epoch's samples silently.  The (partially trained) weights
    are still saved — they are strictly newer than the completed epoch's.
    """
    if not self._preempt_requested:
      return
    epoch, self.epoch = self.epoch, completed_epoch
    try:
      self._save_checkpoint(completed_epoch, save_best=False)
      self._ckpt_writer.flush()  # the process exits right after
      logger.warning("preemption checkpoint written (epoch %d complete); "
                     "exiting", completed_epoch)
    except Exception:
      # A failed save must not masquerade as a clean preemption exit:
      # log it loudly, then still exit 143 (the previous on-disk
      # checkpoint survives).
      logger.exception("preemption checkpoint FAILED; exiting without a "
                       "fresh checkpoint (last periodic save is intact)")
    finally:
      self.epoch = epoch
    raise SystemExit(143)

  # ------------------------------------------------------------------
  def _make_writer(self, log_dir):
    class _Null:
      def add_scalar(self, *a, **k): pass
      def add_text(self, *a, **k): pass
      def add_hparams(self, *a, **k): pass
    if not self.is_primary:   # one TensorBoard stream per experiment
      return _Null()
    try:
      from tensorboardX import SummaryWriter
    except ImportError:
      return _Null()
    return SummaryWriter(str(log_dir))

  def _first_loader(self):
    sets = (self.data_loaders.get("train_sets")
            or self.data_loaders.get("continuous_eval_sets")
            or self.data_loaders["final_eval_sets"])
    return sets[0]

  def _init_state(self):
    """Random weights from the generator.  Also assembles one batch of
    the first loader, as the JAX package's trainer does to take the
    parameter shapes: that draw advances the global numpy stream, which
    the train batches then continue from in both packages."""
    next(iter(self._first_loader()["loader"]))
    self.model.init_weights(self.generator)
    n = sum(p.numel() for p in self.model.parameters())
    logger.info("Initialized model: %s params", f"{n:,}")

  # ------------------------------------------------------------------
  # Train loop
  # ------------------------------------------------------------------
  @_nans_trapped
  def train(self):
    not_improved_count = 0
    for epoch in range(self.start_epoch, self.epochs + 1):
      self.epoch = epoch
      epoch_start = time.time()

      with self.timer.time("epoch.train"):
        # Capture a trace of the first trained epoch when asked.
        with profiler_trace(self.profile_dir,
                            enabled=bool(self.profile_dir) and epoch == 1):
          result = self._train_epoch(epoch)
      for key, val in result.items():
        if np.isscalar(val):
          self.writer.add_scalar(key, val, epoch)

      with self.timer.time("epoch.valid"):
        val_log = self._valid_epoch(epoch, sets="continuous_eval")
      result.update(val_log)

      log = {"epoch": epoch}
      for key, value in result.items():
        if key == "metrics":
          for ds_name, ds_metrics in value.items():
            for m_type, m_dict in ds_metrics.items():
              for m_name, m_value in m_dict.items():
                log[f"{ds_name}/{m_type}/{m_name}"] = m_value
        else:
          log[key] = value

      best = False
      if self.mnt_mode in ("min", "max"):
        try:
          lower = log[self.mnt_metric] <= self.mnt_best
          higher = log[self.mnt_metric] >= self.mnt_best
          improved = ((self.mnt_mode == "min" and lower)
                      or (self.mnt_mode == "max" and higher))
        except KeyError:
          logger.warning("Metric %s not found; monitoring disabled",
                         self.mnt_metric)
          self.mnt_mode = "off"
          improved, not_improved_count = False, 0
        if improved:
          self.mnt_best = log[self.mnt_metric]
          not_improved_count = 0
          best = True
        else:
          not_improved_count += 1
        if not_improved_count > self.early_stop:
          logger.info("No improvement for %s epochs; stopping",
                      self.early_stop)
          break

      # 'save_best' decides whether an off-period save happens at all; the
      # trained_model copy itself follows 'best' (base/base_trainer.py:181-193
      # ordering — monitor='max epoch' refreshes trained_model every epoch).
      save_best = best and getattr(self, "mnt_metric", None) != "epoch"
      if self.mnt_mode == "given_epoch" and epoch == self.given_epoch:
        save_best = True
        best = True

      with self.timer.time("epoch.checkpoint"):
        if epoch < self.skip_first_n_saves:
          logger.info("Skipping ckpt save at epoch %d < %d", epoch,
                      self.skip_first_n_saves)
        elif epoch % self.save_period == 0 or save_best:
          self._save_checkpoint(epoch, save_best=best)
        if epoch > self.num_keep_ckpts and self.is_primary:
          # Routed through the writer queue so the purge always sees the
          # epoch's (possibly still in-flight) checkpoint file.
          self._ckpt_writer.purge(self.exp_dir, self.num_keep_ckpts)
      # SIGTERM between epochs (e.g. during the continuous eval above):
      # this epoch IS complete, checkpoint it as such and exit.
      self._maybe_preempt_exit(epoch)

      self.timer.update("epoch.total", time.time() - epoch_start)
      for key, entry in self.timer.dic.items():
        log[f"timer.{key}.sum"] = entry["sum"]
        self.writer.add_scalar(f"timer_epoch/{key}", entry["sum"], epoch)
      self.writer.add_text("exp_dir", str(self.exp_dir), epoch)
      self.timer.reset()

      log["mnt_best"] = self.mnt_best
      log["not_improved_count"] = not_improved_count
      if np.isfinite(self.mnt_best):  # -inf until first improvement
        self.writer.add_scalar("mnt_best", self.mnt_best, epoch)
      try:
        acc_key = getattr(self, "mnt_metric", None)
        self.writer.add_hparams(
            self.hparams,
            {"hparam/accuracy": log.get(acc_key, 0),
             "hparam/mnt_best": self.mnt_best,
             "hparam/epoch": epoch},
            name="hparams")
      except Exception:  # pragma: no cover - tensorboardX quirk tolerance
        pass

      for name, value in log.items():
        if "/cols" in name:
          continue
        (logger.debug if "timer." in name else logger.info)(
            " %-30s: %s", name, value)
      if self.is_primary:
        update_perf_log({k: v for k, v in log.items()
                         if not k.endswith("cols")}, self.perf_log_path)

    # Join the last background checkpoint write (and surface its error)
    # before callers read the files (evaluate() loads trained_model).
    self._ckpt_writer.flush()

  def _select_train_set(self, epoch):
    """Curriculum: first train set whose until_epoch >= epoch
    (trainer/trainer.py:137-143; past the last until_epoch the final set
    stays in use)."""
    i = 0
    sets = self.data_loaders["train_sets"]
    while i < len(sets) - 1 and sets[i].until_epoch < epoch:
      i += 1
    return sets[i]

  def _checked(self, batches):
    """The host batches, the first one validated (utils/checks.py)."""
    from mmt_tpu_torch.utils.checks import validate_batch
    for i, batch in enumerate(batches):
      if i == 0:
        validate_batch(batch)
      yield batch

  def _train_epoch(self, epoch):
    if epoch == 0:
      # Eval-only baseline epoch (trainer/trainer.py:120-130).
      return {"loss": 0, "learning_rate": self.lr_schedule(0),
              "n_samples": self.n_samples, "n_steps": self.n_steps}

    entry = self._select_train_set(epoch)
    loader = entry["loader"]
    batch_size, n_pairs = entry.batch_size, entry.n_pairs
    max_batches = int(self.max_samples_per_epoch / n_pairs / batch_size)
    batches_per_epoch = min(len(loader), max_batches)
    log_step = max(1, int(np.sqrt(batch_size)))
    # StepLR steps at end of each epoch; epoch e uses rate decayed e-1
    # times (torch calls get_lr before step()).
    epoch_lr = self.lr_schedule(epoch - 1)

    # Losses stay on the device between log points: reading the scalar
    # every step would serialize host and device (the reference pays
    # this with loss.item() each step, trainer/trainer.py:206).  Window
    # reads are PIPELINED one window deep: at each log point the stacked
    # window starts an async device->host copy and the PREVIOUS window
    # (whose copy has long since landed) is logged.
    pending_losses: List[Any] = []
    # The device's step times: a pair of CUDA events around each step,
    # read once the window holding them has landed (no added sync).
    pending_steps: List[Any] = []
    # [(batch_idx, (host window, event), batch_time when it closed,
    #   the window's step events)]
    pending_reads: List[Any] = []
    total_loss = 0.0
    cuda = self.device.type == "cuda"

    def step_event():
      ev = torch.cuda.Event(enable_timing=True)
      ev.record(torch.cuda.current_stream(self.device))
      return ev

    def drain(window):
      nonlocal total_loss
      idx, (host, done), bt, steps = window
      if done is not None:
        done.synchronize()
      for start, end in steps:
        self.timer.update("train_batch.step", start.elapsed_time(end) / 1e3)
      vals = host.numpy()
      total_loss += float(vals.sum())
      logger.info("Train Epoch: %d [%d/%d] Loss: %.6f batch_time=%.5f",
                  epoch, idx + 1, batches_per_epoch, float(vals[-1]), bt)

    data_start = time.time()
    # Cap the source at the epoch's batch budget BEFORE prefetch: the
    # 2-deep prefetch would otherwise assemble (and copy) batches past
    # the epoch boundary that no step ever consumes.
    batches = itertools.islice(iter(loader), batches_per_epoch)
    if self.sanity_checks:
      batches = self._checked(batches)
    batches = (model_batch(b) for b in batches)
    if self.dp is not None:
      batches = (mesh_lib.local_rows(b, self.dp) for b in batches)
    batches = loader_lib.device_prefetch(batches, self.device, size=2)
    for batch_idx, batch in enumerate(spanned(batches, "mmt.loader.wait")):
      self.timer.update("train_batch.data_loading", time.time() - data_start)
      self.n_samples += batch_size * n_pairs
      self.n_steps += 1
      lr = epoch_lr * self.warmup(self.n_steps - 1)

      step_start = time.time()
      start = step_event() if cuda else None
      loss = train_step(self.model, self.optimizer, batch,
                        loss_fn=self.loss_fn, lr=lr,
                        generator=self.generator, dp=self.dp)
      # The host's enqueue; off the card the step ran as it was enqueued.
      dispatch = time.time() - step_start
      if cuda:
        pending_steps.append((start, step_event()))
      else:
        self.timer.update("train_batch.step", dispatch)
      self._maybe_preempt_exit(epoch - 1)
      pending_losses.append(loss)
      self.timer.update("train_batch.dispatch", dispatch)
      self.timer.update("train_batch.total", time.time() - data_start)

      if batch_idx % log_step == 0:
        vals = torch.stack(pending_losses)
        pending_losses = []
        pending_reads.append((batch_idx, _read_async(vals),
                              self.timer.dic["train_batch.total"]["val"],
                              pending_steps))
        pending_steps = []
        while len(pending_reads) > 1:
          drain(pending_reads.pop(0))
      data_start = time.time()

    if pending_losses:
      pending_reads.append((batch_idx,
                            _read_async(torch.stack(pending_losses)),
                            self.timer.dic["train_batch.total"]["val"],
                            pending_steps))
    for window in pending_reads:
      drain(window)
    return {"loss": total_loss / max(batches_per_epoch, 1),
            "learning_rate": epoch_lr,
            "n_samples": self.n_samples, "n_steps": self.n_steps}

  # ------------------------------------------------------------------
  # Eval
  # ------------------------------------------------------------------
  def _get_embeddings(self, loader, to_host=False):
    """Accumulate per-modality embeddings over an eval set
    (trainer/trainer.py:286-370), through the same prefetch as training,
    under ``torch.inference_mode()`` (no autograd graph: the eval FFN
    block launches B1 alone).

    Under data parallelism each batch is zero-padded to a multiple of the
    group, this rank embeds its rows, and the rows are gathered and the
    padding sliced off: every rank holds the whole embeddings.
    ``to_host=True`` (the fused eval) lands each batch's embeddings in
    host memory as numpy arrays, bitwise the device path's, so that the
    corpus never sits whole on one device (mmt_tpu/train/trainer.py:
    745-787); the fused ranking then stages each rank's candidate
    shard."""
    dp = self.dp
    hosts = collections.deque()   # the global host batches, in order

    def rank_rows():
      for batch in loader:
        hosts.append(batch)
        if dp is None:
          yield batch
        else:
          padded, _ = mesh_lib.pad_batch_to_multiple(model_batch(batch),
                                                     dp.size)
          yield mesh_lib.local_rows(padded, dp)

    snap = (lambda x: x.cpu().numpy()) if to_host else (lambda x: x)
    keys = ("vid_embds", "text_embds", "vid_weights", "text_weights")
    embds = {k: [] for k in keys}
    query_masks, raw_captions, paths = [], [], []
    batches = loader_lib.device_prefetch(rank_rows(), self.device, size=2)
    data_start = time.time()
    with torch.inference_mode():
      for batch in spanned(batches, "mmt.loader.wait"):
        host = hosts.popleft()
        # A SIGTERM landing during a long eval must not wait for the
        # whole eval to finish: eval state is safe to abandon, and the
        # current epoch's training is complete whenever an eval runs.
        self._maybe_preempt_exit(self.epoch)
        self.timer.update("valid_batch.data_loading",
                          time.time() - data_start)
        step_start = time.time()
        out = self.model(batch)
        n = len(host["query_masks"])
        for k in keys:
          x = out[k] if dp is None else dp.all_gather(out[k])[:n]
          embds[k].append(snap(x))
        query_masks.append(np.asarray(host["query_masks"]))
        raw_captions.extend(host.get("raw_captions", [None] * n))
        paths.extend(host.get("paths", [""] * n))
        self.timer.update("valid_batch.forward", time.time() - step_start)
        data_start = time.time()
      cat = np.concatenate if to_host else torch.cat
      return {**{k: cat(v, 0) for k, v in embds.items()},
              "query_masks": np.concatenate(query_masks, 0),
              "raw_captions": raw_captions,
              "paths": paths}

  def _valid_epoch(self, epoch=None, sets="continuous_eval"):
    result = {"metrics": {}}
    entries = self.data_loaders.get(f"{sets}_sets", [])
    for entry in entries:
      loader, dataset = entry["loader"], entry["dataset"]
      dataset_name = dataset.dataset_name

      metric_names = {name for name, _ in self.metrics}
      # At >= fused_eval_from_videos videos, rank on the device from the
      # embeddings (ops/ranking.py) instead of materializing the [Q, V]
      # matrix; final_eval keeps the matrix (sims .npy / challenge CSV
      # artifacts need it, trainer/trainer.py:411-437), and so does a
      # configured visualizer, which reads it.
      n_videos = len(dataset)
      use_fused = (sets != "final_eval"
                   and self.fused_eval_from_videos
                   and n_videos >= self.fused_eval_from_videos
                   and metric_names <= {"t2v_metrics", "v2t_metrics"}
                   and not self._want_visualizer)

      # In a group of processes the fused eval embeds to host memory, as
      # the JAX trainer does under a mesh; the candidates split over the
      # data group, if there is one.
      staged = use_fused and self.group is not None
      with self.timer.time("valid.embds"):
        embds = self._get_embeddings(loader, to_host=staged)

      b, k, m, d = embds["text_embds"].shape
      query_masks = embds["query_masks"]
      n_videos = embds["vid_embds"].shape[0]
      sims = sims_dev = None
      if not use_fused:
        with self.timer.time("valid.conf_mat"), torch.inference_mode():
          sims_dev = similarity_ops.moe_similarity(
              embds["text_embds"].reshape(b * k, m, d),
              embds["vid_embds"],
              embds["text_weights"].reshape(b * k, m),
              embds["vid_weights"],
              merge="indep", num_caps=k)
          sims = sims_dev.cpu().numpy()

      # MixDataset evals have dataset_name='Mix' with no cut/split parts
      # (the reference IndexErrors there, trainer/trainer.py:411-437);
      # artifact naming just falls back to the plain name.
      parts = dataset_name.split("_")
      if len(parts) >= 3:
        ds_base, cut_name, split_name = parts[0], parts[1], parts[2]
      else:
        ds_base, cut_name, split_name = dataset_name, "", "eval"

      if sets == "final_eval" and self.is_primary:
        if cut_name == "c" and split_name in ("test1", "test2"):
          public = ("public_server_val" if split_name == "test1"
                    else "public_server_test")
          pred_path = self.exp_dir / f"{ds_base}-{public}-predictions.csv"
          np.savetxt(pred_path,
                     compress_predictions(query_masks, sims),
                     delimiter=",", fmt="%d")
          logger.info("Saved predictions to %s", pred_path)
        sims_path = self.exp_dir / f"{ds_base}-{split_name}-sims.npy"
        np.save(sims_path, {"sims": sims, "query_masks": query_masks})
        logger.info("Saved similarity matrix to %s", sims_path)

      nested = {}
      if use_fused:
        with self.timer.time("valid.conf_mat"), torch.inference_mode():
          nested = metrics_lib.fused_retrieval_metrics(
              embds["text_embds"].reshape(b * k, m, d),
              embds["vid_embds"],
              embds["text_weights"].reshape(b * k, m),
              embds["vid_weights"],
              query_masks, which=tuple(name for name, _ in self.metrics),
              device=self.device, dp=self.dp)
        logger.info("%s: fused on-device ranking (%d videos; sims matrix "
                    "not materialized%s%s)", dataset_name, n_videos,
                    "; host-staged" if staged else "",
                    f", candidates split over {self.dp.size} ranks"
                    if self.dp is not None else "")

      # Tracked throughput metric: eval videos/s on the one device.
      embds_time = self.timer.dic.get("valid.embds", {}).get("val", 0)
      conf_time = self.timer.dic.get("valid.conf_mat", {}).get("val", 0)
      if embds_time + conf_time > 0:
        vps = n_videos / (embds_time + conf_time)
        logger.info("%s eval throughput: %.1f videos/s "
                    "(%d videos, %.3fs embed + %.3fs similarity)",
                    dataset_name, vps, n_videos, embds_time, conf_time)
        self.writer.add_scalar(f"{dataset_name}/eval_videos_per_sec",
                               vps, epoch)

      with self.timer.time("valid.metrics"), torch.inference_mode():
        for name, fn in self.metrics:
          if not use_fused:
            nested[name] = fn(sims_dev, query_masks=query_masks)
          for key, value in nested[name].items():
            if key != "cols":
              self.writer.add_scalar(f"{dataset_name}/{name}/{key}",
                                     value, epoch)
      result["metrics"][dataset_name] = nested

      if self.visualizer is not None and sims is not None:
        with self.timer.time("valid.visu"):
          self.visualizer.visualize_ranking(
              sims=sims, query_masks=query_masks, epoch=epoch,
              meta={"paths": embds["paths"],
                    "raw_captions": embds["raw_captions"],
                    "vid_weights": embds["vid_weights"].cpu().numpy(),
                    "text_weights": embds["text_weights"].reshape(
                        b * k, m).cpu().numpy()},
              nested_metrics=nested, modalities=self.modalities,
              subdir_name=f"{split_name}_{sets}", sets=sets,
              tokenizer=self.tokenizer)
    return result

  @_nans_trapped
  def evaluate(self):
    """Final eval: load best ckpt, run final_eval sets, write artifacts
    (base/base_trainer.py:244-297)."""
    # The primary may still be writing the last checkpoint; every rank
    # must see the same file (or the same absence) before loading.
    self._ckpt_writer.flush()
    self._barrier()
    best = self.exp_dir / ckpt_lib.BEST_NAME
    if best.exists():
      self._resume_checkpoint(best)
    else:
      logger.info("No best checkpoint at %s; evaluating current weights",
                  best)
    final = self._valid_epoch(epoch=self.epoch, sets="final_eval")

    log = {}
    for ds_name, ds_metrics in final["metrics"].items():
      log[ds_name] = {}
      for m_type, m_dict in ds_metrics.items():
        for m_name, m_value in m_dict.items():
          log[ds_name][f"{m_type}/{m_name}/final_eval"] = m_value
    for ds_name, metric_dict in log.items():
      logger.info("%s:", ds_name)
      for name, value in metric_dict.items():
        if "/cols" not in name:
          logger.info(" %-40s: %s", name, value)

    if self.is_primary:
      results_path = self.exp_dir / "exp_results.json"
      res = {}
      if results_path.exists():
        with open(results_path) as f:
          res = json.load(f)
      res["perfs"] = {ds: {k: v for k, v in d.items() if "/cols" not in k}
                      for ds, d in log.items()}
      res["checkpoint_epoch"] = self.loaded_epoch
      with open(results_path, "w") as f:
        # MeanR/MedR can legitimately be inf (a video whose captions are
        # all masked ranks at infinity, ops/ranking.py) — python's json
        # would emit non-RFC `Infinity`, which external parsers reject.
        json.dump(_json_sanitize(res), f, indent=4)
      (self.exp_dir / "exp_completed_flag.txt").touch()
    # Every rank sees the finished artifacts before returning (callers
    # may read exp_results.json right after evaluate()).
    self._barrier()
    return final

  # ------------------------------------------------------------------
  # Checkpointing
  # ------------------------------------------------------------------
  def _state_dict(self):
    """The checkpoint, in the single-process format.  Under tensor
    parallelism a collective of the model group, which gathers the
    parameters' and the moments' shards."""
    params = self.model.state_dict()
    if self.tp is not None:
      params = convert.gather_state_dict(params, self.tp,
                                         self.model.shard_dims)
    state = {
        "state_dict": params,
        "epoch": self.epoch,
        "monitor_best": float(self.mnt_best),
        "n_samples": self.n_samples,
        "n_steps": self.n_steps,
        "config": json.dumps(dict(self.config.raw)),
        "arch": type(self.model).__name__,
        # Dropout generator state: restored on restart so the dropout
        # stream continues exactly (the reference loses its RNG state
        # across --resume).
        "generator": self.generator.get_state(),
    }
    if self.include_optim_in_ckpts:
      optim = self.optimizer.state_dict()
      if self.tp is not None:
        optim = convert.gather_optimizer_state(
            optim, ckpt_lib.param_names_by_position(self.model,
                                                    self.optimizer),
            self.tp, self.model.shard_dims)
      state["optimizer"] = optim
    return state

  def _save_checkpoint(self, epoch, save_best=False):
    # One writer per experiment: every rank holds the same state (under
    # tensor parallelism once gathered, which every rank takes part in),
    # and concurrent writes of one file would race.
    if not self.is_primary and self.tp is None:
      return
    state = self._state_dict()
    if not self.is_primary:
      return
    # Snapshot to host NOW (the next step updates the parameters in
    # place); serialization + write happen on the writer thread.
    self._ckpt_writer.save(self.exp_dir, ckpt_lib.to_host(state), epoch,
                           save_best=save_best)

  def _load_word_vectors(self, weights):
    """The tokenizer's word vectors ([PAD] and [UNK] rows zero) into the
    word-embedding table (train.py:236-239; the reference's
    TxtEmbeddings.from_pretrained).  Before any resume or warm start, so a
    checkpoint's table wins over it (the JAX CLI writes the vectors after
    its resume, over a resumed table: ROADMAP.md C4)."""
    table = self.model.word_embeddings.word_embeddings.weight
    with torch.no_grad():
      table.copy_(torch.as_tensor(np.asarray(weights, np.float32)))
    logger.info("word_embeddings: %d x %d word vectors loaded", *table.shape)

  def _load_txt_bert_init(self, path):
    """Initialize the text tower from converted pretrained BERT weights
    (mmt_tpu/train/trainer.py:_load_txt_bert_init; the reference's
    ``from_pretrained`` for bertftn / bertfrz towers, model/model.py:
    150-162).  The merge is strict: every parameter of ``txt_bert`` must
    be in the asset with its shape, else it raises naming the first one
    (a pretrained encoder over a random word table is the worst silent
    failure).  Parameters only: the tower's buffers keep their values."""
    logger.info("Initializing txt_bert from %s", path)
    if not hasattr(self.model, "txt_bert"):
      logger.warning("txt_bert_init given but the model has no txt_bert "
                     "tower; ignored")
      return
    loaded = shard_for(self.model, ckpt_lib.load_txt_bert_init(path))
    params = {f"txt_bert.{n}": p
              for n, p in self.model.txt_bert.named_parameters()}
    stats = {}
    merged = ckpt_lib.merge_params(
        {k: p.detach() for k, p in params.items()}, loaded, stats=stats)
    if not stats.get("matched"):
      raise ValueError(
          f"txt_bert_init {path}: no leaf matched the model's txt_bert "
          "parameters: wrong geometry or not a text-tower init (convert one "
          "with python -m mmt_tpu_torch.hf_bert)")
    if stats.get("skipped"):
      raise ValueError(
          f"txt_bert_init {path}: {len(stats['skipped'])} txt_bert leaves "
          f"could not be initialized from the asset (first: "
          f"{stats['skipped'][0]}): the tower geometry does not match the "
          "converted weights; fix text_bert_geometry / the vocab, or "
          "convert the right model")
    with torch.no_grad():
      for name, p in params.items():
        p.copy_(merged[name])
    logger.info("txt_bert init: %d/%d leaves loaded from %s",
                stats["matched"], len(params), path)

  def _resume_checkpoint(self, resume_path):
    resume_path = str(resume_path)
    logger.info("Loading checkpoint from %s", resume_path)
    raw = ckpt_lib.load_checkpoint(resume_path)
    restart = os.path.dirname(os.path.abspath(resume_path)) == str(
        self.exp_dir.resolve())

    loaded_cfg = json.loads(raw.get("config", "{}"))
    if loaded_cfg.get("arch") != self.config.raw.get("arch"):
      logger.warning("Architecture config differs from checkpoint")

    state_dict = ckpt_lib.match_checkpoint_to_model(
        shard_for(self.model, raw["state_dict"]), self.model.state_dict())
    if restart:
      self.model.load_state_dict(state_dict, strict=True)
      if "optimizer" in raw and self.include_optim_in_ckpts:
        same_optim = (loaded_cfg.get("optimizer", {}).get("type")
                      == self.config.raw.get("optimizer", {}).get("type"))
        if same_optim:
          optim = ckpt_lib.optimizer_state_by_position(
              raw["optimizer"], self.model, self.optimizer)
          if self.tp is not None:
            optim = convert.shard_optimizer_state(
                optim, ckpt_lib.param_names_by_position(self.model,
                                                        self.optimizer),
                self.tp, self.model.shard_dims)
          self.optimizer.load_state_dict(optim)
        else:
          logger.warning("Optimizer type changed; not resuming its state")
      self.loaded_epoch = int(raw.get("epoch", 0))
      self.epoch = self.loaded_epoch
      self.start_epoch = self.loaded_epoch + 1
      self.n_samples = int(raw.get("n_samples", 0))
      self.n_steps = int(raw.get("n_steps", 0))
      self.mnt_best = float(raw.get("monitor_best", self.mnt_best))
      if raw.get("generator") is not None:
        self.generator.set_state(raw["generator"])
    else:
      # Warm start: non-strict load, counters reset
      # (base/base_trainer.py:452-462).
      self.model.load_state_dict(ckpt_lib.merge_params(
          self.model.state_dict(), state_dict))
      self.loaded_epoch = int(raw.get("epoch", 0))
      self.epoch = 0
      self.start_epoch = 0
      self.n_samples = 0
      self.n_steps = 0
      if self.is_primary:
        ckpt_lib.write_info(self.exp_dir, resume_path, self.loaded_epoch)
    logger.info("Ckpt loaded at epoch %s", raw.get("epoch", "?"))
