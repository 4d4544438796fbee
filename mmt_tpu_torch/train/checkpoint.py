"""Checkpointing: atomic torch.save of the trainer state with the
reference's resume semantics.

Port of mmt_tpu/train/checkpoint.py (base/base_trainer.py:346-464 and
utils/util.py:71-82 semantics):

* state = {state_dict, optimizer?, epoch, n_samples, n_steps,
  monitor_best, config, arch, generator}: ``state_dict`` is the model's in
  the reference's names, buffers included (the BatchNorm running
  statistics are part of the state), ``generator`` the dropout
  generator's state; saved crash-safe via tmp + os.rename as
  ``checkpoint-epoch{N}.pth``;
* best-model copy ``trained_model.pth``;
* stale-checkpoint purge keeping the newest ``num_keep_ckpts``;
* restart (same exp dir) = strict load incl. optimizer + counters;
  warm start (--load_checkpoint) = non-strict merge by name and shape,
  counters reset (the trainer does both);
* cross-config transfer zero-pads the ``vid_bert`` position-embedding
  rows so a 32-slot pretrain loads into a 102-slot finetune model
  (base/base_trainer.py:391-406).

``load_checkpoint`` also reads the JAX package's ``.msgpack`` checkpoints
(``serialization.msgpack_restore``, then ``convert.checkpoint_from_flax``)
into the same layout; ``last_checkpoint`` takes either suffix (the
highest epoch; at equal epochs the ``.pth``, which the port wrote after
resuming), so ``--resume EXPDIR`` resumes a JAX experiment, while the
purge deletes only the port's ``.pth`` files.

Under data parallelism only the primary rank saves and purges (the
trainer gates every write: ``Trainer._save_checkpoint``), while every
rank reads the same files on resume and before the final eval, after a
barrier.  Under tensor parallelism the file is the single-process one
too: the parameters and the optimizer's moments are gathered from the
model group before the primary writes (``convert.gather_state_dict``,
``gather_optimizer_state``), and every read is cut to the rank's shards
(``param_names_by_position`` maps the optimizer's positions to the
parameters' names and so to their split).
"""

from __future__ import annotations

import concurrent.futures
import io
import logging
import os
import pathlib
import re
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

# The purge deletes .pth files only: never the JAX package's .msgpack
# checkpoints sharing an exp dir, which auto-resume also reads.
CKPT_RE = r"checkpoint-epoch(\d+)\.pth$"
RESUME_RE = r"checkpoint-epoch(\d+)\.(pth|msgpack)$"
BEST_NAME = "trained_model.pth"
POS_EMB = "vid_bert.embeddings.position_embeddings.weight"


def _atomic_write(path, data: bytes):
  # pid-unique tmp name: a stray concurrent writer (e.g. an
  # operator-launched eval job) must corrupt nothing.
  tmp = f"{path}._{os.getpid()}_tmp"
  with open(tmp, "wb") as f:
    f.write(data)
  os.rename(tmp, path)


def to_host(obj):
  """A copy of ``obj`` with every tensor (in nested dicts, lists and
  tuples) detached and copied to the CPU: the snapshot a background write
  may hold while training goes on updating the originals."""
  if isinstance(obj, torch.Tensor):
    return obj.detach().to("cpu", copy=True)
  if isinstance(obj, dict):
    return {k: to_host(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(to_host(v) for v in obj)
  return obj


def save_checkpoint(ckpt_dir, state: Dict[str, Any], epoch: int,
                    save_best: bool = False) -> str:
  """Serialize the state once; write it as the epoch's checkpoint and,
  with ``save_best``, as trained_model.pth."""
  ckpt_dir = pathlib.Path(ckpt_dir)
  ckpt_dir.mkdir(parents=True, exist_ok=True)
  buf = io.BytesIO()
  torch.save(state, buf)
  blob = buf.getvalue()
  path = ckpt_dir / f"checkpoint-epoch{epoch}.pth"
  tic = time.time()
  _atomic_write(path, blob)
  logger.info("Saved checkpoint %s in %.3fs", path, time.time() - tic)
  if save_best:
    _atomic_write(ckpt_dir / BEST_NAME, blob)
  return str(path)


class AsyncCheckpointWriter:
  """Overlap checkpoint encode+write with the next epoch's compute.

  The caller snapshots the state to host memory first (``to_host``: the
  next train step updates the parameters in place), then hands the host
  copy to a single background worker that serializes and writes it.

  Ordering and safety:
  * one worker thread, one job in flight: each ``save``/``purge`` first
    joins the previous job, so host memory is bounded at ~2 state copies
    and on-disk effects happen in submission order (a purge submitted
    after a save always sees the save's file);
  * worker exceptions are re-raised at the NEXT ``save``/``purge``/
    ``flush`` — a failed write cannot be silently lost;
  * ``flush()`` must be called before any read of the files (end of
    ``train()``, before final-eval checkpoint load, preemption exit).

  ``async_enabled=False`` degrades to the synchronous inline behavior.
  """

  def __init__(self, async_enabled: bool = True):
    self._pool = (concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="ckpt-writer")
                  if async_enabled else None)
    self._pending: Optional[concurrent.futures.Future] = None

  def _submit(self, fn):
    if self._pool is None:
      fn()
      return
    self.flush()
    self._pending = self._pool.submit(fn)

  def save(self, ckpt_dir, host_state: Dict[str, Any], epoch: int,
           save_best: bool = False):
    """Serialize+write ``host_state`` (CPU tensors, see ``to_host``) in
    the background."""
    self._submit(lambda: save_checkpoint(ckpt_dir, host_state, epoch,
                                         save_best=save_best))

  def purge(self, ckpt_dir, num_keep: int = 1):
    self._submit(lambda: purge_stale_checkpoints(ckpt_dir, num_keep))

  def flush(self):
    """Join the in-flight write; re-raise its exception, if any."""
    if self._pending is not None:
      pending, self._pending = self._pending, None
      pending.result()


def load_checkpoint(path) -> Dict[str, Any]:
  """A checkpoint, its tensors on the CPU: a ``.pth`` written by
  ``save_checkpoint`` (tensors, containers and plain values only: nothing
  else is unpickled), or a ``.msgpack`` the JAX trainer wrote, in the same
  layout (``convert.checkpoint_from_flax``: its ``optimizer`` keyed by
  parameter name, see ``optimizer_state_by_position``)."""
  if str(path).endswith(".msgpack"):
    from mmt_tpu_torch import convert, serialization
    return convert.checkpoint_from_flax(serialization.msgpack_restore(path))
  return torch.load(path, map_location="cpu", weights_only=True)


def load_txt_bert_init(path) -> Dict[str, torch.Tensor]:
  """The text tower of a pretrained-init asset, as {``txt_bert.*``:
  tensor}: a ``.pth`` in the port's layout (``hf_bert``'s output, or a
  checkpoint), or a ``.msgpack`` (the JAX converter's ``{"params":
  {"txt_bert": tree}}``, a JAX checkpoint, or a bare tower tree, read as
  the JAX trainer reads them)."""
  path = str(path)
  if path.endswith(".msgpack"):
    from mmt_tpu_torch import convert, serialization
    tree = serialization.msgpack_restore(path)
    tree = tree.get("params", tree)
    tree = tree.get("txt_bert", tree)
    return convert.state_dict_from_flax({"txt_bert": tree}, {})
  raw = torch.load(path, map_location="cpu", weights_only=True)
  if "state_dict" not in raw:
    raise ValueError(f"txt_bert_init {path}: no state_dict; an HF "
                     "checkpoint is converted first, with python -m "
                     "mmt_tpu_torch.hf_bert")
  return {k: v for k, v in raw["state_dict"].items()
          if k.startswith("txt_bert.")}


def optimizer_state_by_position(state, model, optimizer):
  """``state`` for ``optimizer.load_state_dict``: one keyed by parameter
  name (a JAX checkpoint's) is re-keyed by each parameter's position in
  ``optimizer`` (whose parameters are ``model``'s), its group taking the
  optimizer's hyperparameters with the saved learning rate; a state keyed
  by position is returned as it is.  The state of a parameter the
  optimizer does not hold (a frozen one: a JAX freeze mask zeroes the
  update after the optimizer, whose moments still cover it) is dropped,
  with an info log."""
  saved = state["param_groups"]
  if not any(isinstance(p, str) for g in saved for p in g["params"]):
    return state
  if len(saved) != 1 or len(optimizer.param_groups) != 1:
    raise ValueError("a state keyed by name loads into one param group")
  params = dict(model.named_parameters())
  names = {n: i for i, n in param_names_by_position(model,
                                                     optimizer).items()}
  unknown = [n for n in state["state"] if n not in params]
  if unknown:
    raise KeyError(f"optimizer state for {len(unknown)} parameters the "
                   f"model does not have (first: {unknown[0]})")
  frozen = [n for n in state["state"] if n not in names]
  if frozen:
    logger.info("optimizer state of %d frozen parameters dropped (first: "
                "%s): the optimizer does not hold them", len(frozen),
                frozen[0])
  group = {k: v for k, v in optimizer.param_groups[0].items()
           if k != "params"}
  group.update({k: v for k, v in saved[0].items() if k != "params"},
               params=list(range(len(names))))
  return {"state": {names[n]: v for n, v in state["state"].items()
                    if n in names},
          "param_groups": [group]}


def param_names_by_position(model, optimizer):
  """{position in ``optimizer``'s state dict: ``model``'s name of that
  parameter}."""
  names = {id(p): n for n, p in model.named_parameters()}
  return dict(enumerate(names[id(p)] for g in optimizer.param_groups
                        for p in g["params"]))


def last_checkpoint(exp_dir) -> Optional[str]:
  """Highest-epoch checkpoint in a directory (utils/util.py:71-82), the
  port's ``.pth`` or the JAX package's ``.msgpack``; at equal epochs the
  ``.pth``."""
  best, best_key = None, None
  if not os.path.isdir(exp_dir):
    return None
  for fname in os.listdir(exp_dir):
    m = re.search(RESUME_RE, fname)
    key = m and (int(m.group(1)), m.group(2) == "pth")
    if m and (best_key is None or key > best_key):
      best_key = key
      best = os.path.join(exp_dir, fname)
  return best


def purge_stale_checkpoints(ckpt_dir, num_keep: int = 1):
  """Drop all but the newest ``num_keep`` epoch checkpoints
  (base/base_trainer.py:299-323; trained_model is never purged)."""
  ckpt_dir = pathlib.Path(ckpt_dir)
  found = []
  for p in ckpt_dir.glob("checkpoint-epoch*.pth"):
    m = re.search(CKPT_RE, str(p))
    if m:
      found.append((int(m.group(1)), p))
  for epoch, path in sorted(found, key=lambda x: -x[0])[num_keep:]:
    path.unlink()
    logger.info("removed stale ckpt [epoch %d]", epoch)


def match_checkpoint_to_model(loaded, target):
  """Zero-pad the vid_bert position embeddings of a loaded state dict
  whose table has fewer rows than the model's
  (base/base_trainer.py:391-406 transfer rule)."""
  if POS_EMB not in loaded or POS_EMB not in target:
    return loaded
  emb, tgt = loaded[POS_EMB], target[POS_EMB]
  if emb.shape != tgt.shape and emb.shape[0] < tgt.shape[0]:
    pad = emb.new_zeros((tgt.shape[0] - emb.shape[0], emb.shape[1]))
    loaded = {**loaded, POS_EMB: torch.cat([emb, pad], 0)}
    logger.warning("vid_bert position embeddings zero-padded %s -> %s",
                   tuple(emb.shape), tuple(tgt.shape))
  return loaded


def merge_params(target, loaded, stats=None):
  """Non-strict merge of state dicts: each entry of ``target`` takes the
  loaded tensor of the same name and shape (cast to its dtype), else
  keeps its own (torch load_state_dict(strict=False) semantics, plus the
  shape check, for warm starts).

  ``stats`` (optional dict) gets ``stats["matched"]`` incremented per
  copied entry and ``stats["skipped"]`` (a list of names) appended per
  kept one.
  """
  out = {}
  for name, tgt in target.items():
    got = loaded.get(name)
    if got is None or tuple(got.shape) != tuple(tgt.shape):
      why = ("missing" if got is None else
             f"shape mismatch ({tuple(got.shape)} vs {tuple(tgt.shape)})")
      logger.warning("warm start: %s at %s (kept init)", why, name)
      if stats is not None:
        stats.setdefault("skipped", []).append(name)
      out[name] = tgt
      continue
    if stats is not None:
      stats["matched"] = stats.get("matched", 0) + 1
    out[name] = got.to(tgt.dtype)
  return out


def write_info(exp_dir, resume_path, epoch):
  """Provenance note for warm starts (base/base_trainer.py:459-462)."""
  with open(pathlib.Path(exp_dir) / "info_checkpoint.txt", "a") as f:
    f.write(f"This experiment is based on the checkpoint {resume_path} "
            f"loaded at epoch {epoch}\n")
