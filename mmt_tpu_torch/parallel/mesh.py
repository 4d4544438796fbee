"""Parallelism over torch.distributed: the JAX package's 'data' and
'model' mesh axes as groups of ranks, one process each.

A ``Group`` is this process's place in such a group, for either axis
(``DataParallel`` and ``TensorParallel`` are its names as each axis's
argument): rank, size, the process group and its backend, and the one
set of collectives both axes use.  Every collective goes through
``Group.reduce_`` / ``Group.all_gather``, which copy a CUDA tensor
through host memory on gloo and hand it to NCCL as it is.

Data parallelism (mmt_tpu/parallel/mesh.py:1-20): every rank holds the
whole model and rows [rank * n, (rank + 1) * n) of each global batch.
The loss is the global batch's (global-batch negatives), so
``gather_rows`` all-gathers the rank's outputs and every rank computes
the same [B, B] similarity and the same loss.  Its backward keeps the
rank's own rows of the incoming gradient: each rank's parameter gradients
are then its rows' share, and ``all_reduce_grads`` SUMS them (one flat
buffer) into the single-device gradient.  Train-mode BatchNorm takes the
global batch's moments through ``all_reduce_sum``, whose backward
all-reduces too (each rank holds the loss's gradient through its own rows
only).  ``maybe_initialize_distributed`` joins the group from the JAX
package's environment interface (MMT_TPU_COORDINATOR,
MMT_TPU_NUM_PROCESSES, MMT_TPU_PROCESS_ID); ``choose_backend`` is the
rule for its backend.

Tensor parallelism: the collectives that GSPMD and the partition bodies
of mmt_tpu/ops/ffn.py:_tp_row_sharded insert around the Megatron layout
of mmt_tpu/parallel/mesh.py:param_shardings.  The layout itself, in the
reference's torch names and nn.Linear's [out, in] layout, is decided by
each encoder layer (models/bert.py ``TransformerLayer.shard_dims``):

* ``intermediate.dense`` and ``attention.self.{query,key,value}`` are
  column-parallel: weight and bias split on dim 0 (JAX's kernel [D, I]
  dim 1).  q/k/v split by heads: heads / size on each rank.
* ``output.dense`` and ``attention.output.dense`` are row-parallel: the
  weight splits on dim 1 (JAX's kernel [I, D] dim 0), the bias stays
  whole; the product is a partial sum that ``reduce_from_tp`` all-reduces.
* Everything else is replicated.  The FFN stays whole when the
  intermediate size does not divide by the group's size, the attention
  when the head count does not (``heads_ok``).

``copy_to_tp`` and ``reduce_from_tp`` are Megatron's *f* and *g*: f is
the identity forward and all-reduces the gradient backward (it stands
before a column-parallel product, whose input every rank holds whole);
g all-reduces forward and is the identity backward (its output is
replicated, so each rank's gradient is already the whole gradient).
Both reduce in fp32.  (``torch.distributed.nn.functional.all_reduce``
all-reduces in its backward too, which for g gives size x the gradient.)

Both axes at once (``data_mesh``): ranks laid out as the JAX package's
2-D mesh, ``n // M`` data ranks of ``M`` model ranks each; the data
group of a rank holds the ranks with its model index, its model group
the ``M`` consecutive ranks of its data index.  A sharded serving index
is one process over the local cards (``local_mesh``), not ranks, as the
JAX engine is one process over its local chips.

``spawn`` runs a function on each rank of a new group of processes
(start method ``spawn``, so it may be called from a process that holds
a CUDA context).  On one card the ranks share the device over gloo,
which all-reduces CUDA tensors through host memory; NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import multiprocessing
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


RENDEZVOUS_TIMEOUT_S = 1800.0   # maybe_initialize_distributed's


@dataclasses.dataclass(frozen=True)
class Group:
  """This process's place in a group of ``size`` ranks, for either mesh
  axis; ``backend`` is the group's (``choose_backend``).  As a data-
  parallel group: the whole model, and rows [rank * n, (rank + 1) * n) of
  every global batch of n * size rows.  As a tensor-parallel group: this
  rank's shards of the Megatron layout."""
  rank: int
  size: int
  group: Any = None   # torch.distributed process group; None: the default
  backend: str = "gloo"

  @property
  def primary(self) -> bool:
    """Rank 0: the one process that writes files."""
    return self.rank == 0

  def rows(self, n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` rows."""
    if n_global % self.size:
      raise ValueError(f"a batch of {n_global} rows does not divide over "
                       f"{self.size} data-parallel ranks")
    n = n_global // self.size
    return slice(self.rank * n, (self.rank + 1) * n)

  def reduce_(self, t):
    """Sum ``t`` over the group in place.  On gloo a CUDA tensor goes
    through a host copy (gloo's own CUDA path does the same, for fewer
    types); NCCL takes it as it is."""
    if t.is_cuda and self.backend != "nccl":
      host = t.cpu()
      dist.all_reduce(host, group=self.group)
      t.copy_(host)
    else:
      dist.all_reduce(t, group=self.group)
    return t

  def all_reduce(self, x):
    """Sum of x over the group's ranks, in fp32 (a new tensor)."""
    return self.reduce_(x.to(torch.float32, copy=True))

  def all_gather(self, x):
    """The ranks' x concatenated along dim 0, in rank order (x has the
    same shape on every rank)."""
    x = x.contiguous()
    if x.is_cuda and self.backend == "nccl":
      out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
      dist.all_gather_into_tensor(out, x, group=self.group)
      return out
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(self.size)]
    dist.all_gather(parts, host, group=self.group)
    return torch.cat(parts, 0).to(x.device)

  def barrier(self):
    """Wait for every rank (an all-reduce of one number, on the card for
    NCCL, so that no device guess is needed)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if self.backend == "nccl" else torch.device("cpu"))
    self.reduce_(torch.zeros(1, device=dev))


# The two axes' names for the one group type, as their callers take it.
DataParallel = TensorParallel = Group


def init_tensor_parallel(rank: int, size: int, *, init_method: str,
                         backend: str = "gloo",
                         timeout: float = 120.0) -> Group:
  """Join a group of ``size`` processes as ``rank`` (the default process
  group) over ``backend``; a rendezvous that takes longer than
  ``timeout`` seconds raises."""
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=size,
                          timeout=datetime.timedelta(seconds=timeout))
  return Group(rank, size, dist.group.WORLD, backend)


def data_mesh(group: Optional[Group], model_parallel: int = 1):
  """This rank's (data Group, model Group) in the 2-D layout of
  ``group``'s ranks, the JAX package's ``data_mesh(model_parallel=M)``
  (mmt_tpu/parallel/mesh.py:69-80): the ranks laid out as
  ``arange(n).reshape(n // M, M)``, so rank r is model rank r % M of
  data rank r // M and a model group is M consecutive ranks.  An axis of
  size 1 is None (no group to split over); so are both without a group
  of more than one process.

  Every rank creates every group (``dist.new_group``), in the same
  order.  Raises ValueError when M does not divide the ranks, and when
  the ranks of one model group sit on different hosts (the JAX trainer
  refuses a model axis across hosts: the per-layer all-reduces would
  leave the host's interconnect; mmt_tpu/train/trainer.py:149-157).
  The groups take ``group``'s backend (``choose_backend``)."""
  n = 1 if group is None else group.size
  if model_parallel < 1 or n % model_parallel:
    raise ValueError(f"model_parallel={model_parallel} does not divide the "
                     f"{n} ranks")
  if n == 1:
    return None, None
  if model_parallel == 1:
    return group, None
  grid = np.arange(n).reshape(n // model_parallel, model_parallel)
  hosts = [None] * n
  dist.all_gather_object(hosts, socket.gethostname(), group=group.group)
  for row in grid:
    names = sorted({hosts[r] for r in row})
    if len(names) > 1:
      raise ValueError(
          f"model_parallel={model_parallel}: the model group of ranks "
          f"{row.tolist()} spans hosts {names}; a model axis stays on one "
          "host (its per-layer all-reduces would cross hosts)")
  data_groups = [dist.new_group(col.tolist()) for col in grid.T]
  model_groups = [dist.new_group(row.tolist()) for row in grid]
  d, m = divmod(group.rank, model_parallel)
  data = (Group(d, grid.shape[0], data_groups[m], group.backend)
          if grid.shape[0] > 1 else None)
  return data, Group(m, model_parallel, model_groups[d], group.backend)


def local_mesh(device) -> Optional[list]:
  """The local CUDA devices a serving index shards over, one shard each:
  a list of torch devices, or None with one device (or on the CPU), as
  the JAX package's ``data_mesh()`` returns None for one chip."""
  device = torch.device(device)
  cards = torch.cuda.device_count() if device.type == "cuda" else 0
  if cards <= 1:
    return None
  return [torch.device("cuda", i) for i in range(cards)]


class _CopyToTP(torch.autograd.Function):
  """Megatron's f: identity forward, all-reduce of the gradient."""

  @staticmethod
  def forward(ctx, x, tp):
    ctx.tp = tp
    return x.view_as(x)

  @staticmethod
  def backward(ctx, dy):
    return ctx.tp.all_reduce(dy).to(dy.dtype), None


class _ReduceFromTP(torch.autograd.Function):
  """Megatron's g: all-reduce forward (fp32 out), identity gradient."""

  @staticmethod
  def forward(ctx, x, tp):
    ctx.dtype = x.dtype
    return tp.all_reduce(x)

  @staticmethod
  def backward(ctx, dy):
    return dy.to(ctx.dtype), None


def copy_to_tp(x, tp: TensorParallel):
  """Megatron's f on the input of a column-parallel product."""
  return _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: TensorParallel):
  """Megatron's g on the partial output of a row-parallel product: the
  fp32 sum over the ranks."""
  return _ReduceFromTP.apply(x, tp)


# ----------------------------------------------------------------------
# Data parallelism
# ----------------------------------------------------------------------
def row_part(dp, x):
  """``ops.dropout``'s ``part`` for x, this rank's rows of a global tensor
  of size x rows along dim 0 (None without ``dp``): the mask is drawn at
  the global shape."""
  if dp is None or dp.size == 1:
    return None
  n = x.shape[0]
  return (0, dp.rank * n, dp.size * n)


class _GatherRows(torch.autograd.Function):
  """All-gather of the ranks' rows; the backward keeps this rank's rows
  of the gradient."""

  @staticmethod
  def forward(ctx, x, dp):
    ctx.dp, ctx.n = dp, x.shape[0]
    return dp.all_gather(x)

  @staticmethod
  def backward(ctx, dy):
    start = ctx.dp.rank * ctx.n
    return dy[start:start + ctx.n], None


def gather_rows(x, dp: DataParallel):
  """The global batch's x [n * size, ...] from this rank's rows x [n,
  ...], differentiable.

  Every rank computes the same function of the gathered rows (the global
  loss), so each already holds the whole gradient of the gathered tensor;
  the backward keeps this rank's rows of it.  Each rank's parameter
  gradients are then the share of the loss that flows through its rows,
  and they are SUMMED across ranks (``all_reduce_grads``), not averaged:
  the sum is the single-device gradient of the global loss.  (A backward
  that reduce-scatters would give size x that share, to be averaged.)"""
  return _GatherRows.apply(x, dp)


class _AllReduceSum(torch.autograd.Function):
  """Sum over the ranks; the backward sums the gradient over the ranks."""

  @staticmethod
  def forward(ctx, x, dp):
    ctx.dp = dp
    return dp.reduce_(x.clone())

  @staticmethod
  def backward(ctx, dy):
    return ctx.dp.reduce_(dy.clone()), None


def all_reduce_sum(x, dp: DataParallel):
  """The sum of x over the ranks (a new tensor), differentiable: the
  global-batch BatchNorm sums.  Each rank's loss gradient reaches the sum
  through its own rows only, so the backward all-reduces the gradient,
  giving every rank the whole gradient of the sum."""
  return _AllReduceSum.apply(x, dp)


def all_reduce_grads(params, dp: DataParallel):
  """Sum the gradients of ``params`` over the ranks, in one flat fp32
  buffer.  Frozen parameters and parameters without a gradient are left
  out; the same ones on every rank, since every rank runs the same
  program."""
  grads = [p.grad for p in params
           if p.requires_grad and p.grad is not None]
  if not grads:
    return
  flat = torch.cat([g.reshape(-1).float() for g in grads])
  dp.reduce_(flat)
  offset = 0
  for g in grads:
    g.copy_(flat[offset:offset + g.numel()].view_as(g))
    offset += g.numel()


def _map_rows(batch, n, fn):
  """``batch`` with ``fn`` applied to every numpy array or list of ``n``
  rows (in nested dicts); anything else passes through."""
  if isinstance(batch, dict):
    return {k: _map_rows(v, n, fn) for k, v in batch.items()}
  if isinstance(batch, (np.ndarray, list)) and len(batch) == n:
    return fn(batch)
  return batch


def local_rows(batch, dp: DataParallel, key="token_ids"):
  """This rank's rows of a global host batch (numpy arrays and lists; the
  batch size is ``batch[key]``'s rows)."""
  n = len(batch[key])
  rows = dp.rows(n)
  return _map_rows(batch, n, lambda x: x[rows])


def pad_batch_to_multiple(batch, multiple: int, key="token_ids"):
  """Zero-pad every array's leading axis to a multiple of ``multiple``
  (mmt_tpu/train/trainer.py:82).  Padded rows have all-zero masks and
  indicators, so they embed to harmless values that the caller slices
  off; returns (padded, the original row count)."""
  n = len(batch[key])
  pad = (-n) % multiple
  if pad == 0:
    return batch, n

  def pad_rows(x):
    if isinstance(x, list):
      return x + [x[-1]] * pad
    return np.pad(np.asarray(x), [(0, pad)] + [(0, 0)] * (x.ndim - 1))

  return _map_rows(batch, n, pad_rows), n


def choose_backend(world_size: int, device_type: str, cards: int,
                   cpu_collectives: Optional[str] = None) -> str:
  """The backend of a group of ``world_size`` ranks on ``device_type``
  with ``cards`` visible CUDA devices: ``cpu_collectives`` (default gloo)
  on the CPU; nccl when every rank has a card of its own (rank r on
  cuda:r % cards); gloo when ranks share a card (NCCL refuses two ranks
  on one device)."""
  if device_type != "cuda":
    return cpu_collectives or "gloo"
  return "nccl" if world_size <= cards else "gloo"


def rank_device(device, rank: int) -> torch.device:
  """``device`` for ``rank``: a CUDA device without an index becomes
  cuda:rank % (visible cards)."""
  device = torch.device(device)
  if device.type == "cuda" and device.index is None:
    cards = torch.cuda.device_count()
    if cards:
      return torch.device("cuda", rank % cards)
  return device


def maybe_initialize_distributed(device="cuda") -> Optional[Group]:
  """Join the data-parallel group that the environment describes, as the
  JAX package's ``maybe_initialize_distributed`` does
  (mmt_tpu/parallel/mesh.py:35-66): MMT_TPU_COORDINATOR (host:port of
  rank 0's rendezvous), MMT_TPU_NUM_PROCESSES and MMT_TPU_PROCESS_ID.
  Returns None without a coordinator or with one process.  The backend
  follows ``choose_backend`` for ``device`` (MMT_TPU_CPU_COLLECTIVES
  names the CPU's) and is logged; a failed initialization (or a
  rendezvous longer than RENDEZVOUS_TIMEOUT_S) raises, and no other
  backend is tried.  Idempotent: once the process group exists,
  later calls return it."""
  if dist.is_initialized():
    return Group(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                 dist.get_backend())
  coordinator = os.environ.get("MMT_TPU_COORDINATOR")
  if not coordinator:
    return None
  size = int(os.environ.get("MMT_TPU_NUM_PROCESSES", "1"))
  rank = int(os.environ.get("MMT_TPU_PROCESS_ID", "0"))
  if size <= 1:
    return None
  if not 0 <= rank < size:
    raise ValueError(f"MMT_TPU_PROCESS_ID={rank} is not a rank of "
                     f"MMT_TPU_NUM_PROCESSES={size}")
  dev = rank_device(device, rank)
  cards = 0
  if dev.type == "cuda":
    # A device named with its index puts every rank on that one card.
    cards = (1 if torch.device(device).index is not None
             else torch.cuda.device_count())
  backend = choose_backend(size, dev.type, cards,
                           os.environ.get("MMT_TPU_CPU_COLLECTIVES"))
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  init = (coordinator if "://" in coordinator else f"tcp://{coordinator}")
  logger.info("data parallel: rank %d of %d, backend %s (device %s, %d "
              "visible cards), rendezvous %s", rank, size, backend, dev,
              cards, init)
  dist.init_process_group(backend, init_method=init, rank=rank,
                          world_size=size,
                          timeout=datetime.timedelta(
                              seconds=RENDEZVOUS_TIMEOUT_S))
  return Group(rank, size, dist.group.WORLD, backend)


def _free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _rank_main(fn, rank, size, init_method, backend, timeout, args, results):
  """One rank: join the group, run fn, report (rank, ok, value)."""
  try:
    group = init_tensor_parallel(rank, size, init_method=init_method,
                                 backend=backend, timeout=timeout)
    try:
      value = fn(group, *args)
    finally:
      dist.destroy_process_group()
    results.put((rank, True, value))
  except Exception:   # the process's boundary: report the traceback
    results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, model_parallel: int, *args, backend: str = "gloo",
          timeout: float = 120.0) -> list:
  """Run ``fn(group, *args)`` on each of ``model_parallel`` new
  processes, joined as one ``Group`` over ``backend`` at a free localhost
  port (for either axis); returns their results in rank order.

  ``fn`` and ``args`` are pickled by the ``spawn`` start method (``fn``
  by import path) and so are the results: return numpy arrays or Python
  values, not tensors.  Raises RuntimeError, after stopping every rank,
  if a rank raises or dies, or if the ranks are not all done within
  ``timeout`` seconds (a hung rendezvous or collective fails; it does not
  hang).
  """
  ctx = multiprocessing.get_context("spawn")
  results = ctx.Queue()
  init_method = f"tcp://localhost:{_free_port()}"
  procs = [ctx.Process(target=_rank_main, daemon=True,
                       args=(fn, rank, model_parallel, init_method, backend,
                             timeout, args, results))
           for rank in range(model_parallel)]
  done, failed = {}, {}
  deadline = time.monotonic() + timeout
  try:
    for p in procs:
      p.start()
    while len(done) + len(failed) < model_parallel and not failed:
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        missing = sorted(set(range(model_parallel)) - set(done))
        raise RuntimeError(f"ranks {missing} did not finish "
                           f"within {timeout} s")
      try:
        rank, ok, value = results.get(timeout=min(remaining, 1.0))
      except queue_lib.Empty:
        for rank, p in enumerate(procs):
          if p.exitcode not in (None, 0) and rank not in done:
            failed[rank] = f"exited with code {p.exitcode}, reporting nothing"
        continue
      (done if ok else failed)[rank] = value
  finally:
    for p in procs:
      # A failed group gets a grace to stop; a late one is stopped now.
      p.join(timeout=5.0 if failed else max(deadline - time.monotonic(),
                                            1.0))
      if p.is_alive():
        p.kill()
        p.join(timeout=5.0)
  if failed:
    rank = min(failed)
    raise RuntimeError(f"rank {rank} of {model_parallel} "
                       f"failed:\n{failed[rank]}")
  return [done[r] for r in range(model_parallel)]
