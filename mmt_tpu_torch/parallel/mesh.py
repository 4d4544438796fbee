"""Tensor parallelism over torch.distributed: the JAX package's 'model'
mesh axis as one group of ranks, one process each.

The group and the collectives that GSPMD and the partition bodies of
mmt_tpu/ops/ffn.py:_tp_row_sharded insert around the Megatron layout of
mmt_tpu/parallel/mesh.py:param_shardings.  The layout itself, in the
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

``spawn`` runs a function on each rank of a new group of processes
(start method ``spawn``, so it may be called from a process that holds
a CUDA context).  On one card the ranks share the device over gloo,
which all-reduces CUDA tensors through host memory; NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
  """This process's place in a tensor-parallel group."""
  rank: int
  size: int
  group: Any = None   # torch.distributed process group; None: the default

  def all_reduce(self, x):
    """Sum of x over the group's ranks, in fp32 (a new tensor)."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=self.group)
    return y


def init_tensor_parallel(rank: int, size: int, *, init_method: str,
                         backend: str = "gloo",
                         timeout: float = 120.0) -> TensorParallel:
  """Join a group of ``size`` processes as ``rank`` (the default process
  group) over ``backend``; a rendezvous that takes longer than
  ``timeout`` seconds raises."""
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=size,
                          timeout=datetime.timedelta(seconds=timeout))
  return TensorParallel(rank, size, dist.group.WORLD)


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


def _free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _rank_main(fn, rank, size, init_method, backend, timeout, args, results):
  """One rank: join the group, run fn, report (rank, ok, value)."""
  try:
    tp = init_tensor_parallel(rank, size, init_method=init_method,
                              backend=backend, timeout=timeout)
    try:
      value = fn(tp, *args)
    finally:
      dist.destroy_process_group()
    results.put((rank, True, value))
  except Exception:   # the process's boundary: report the traceback
    results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, model_parallel: int, *args, backend: str = "gloo",
          timeout: float = 120.0) -> list:
  """Run ``fn(tp, *args)`` on each of ``model_parallel`` new processes,
  joined as one tensor-parallel group over ``backend`` at a free
  localhost port; returns their results in rank order.

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
        raise RuntimeError(f"tensor-parallel ranks {missing} did not finish "
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
    raise RuntimeError(f"tensor-parallel rank {rank} of {model_parallel} "
                       f"failed:\n{failed[rank]}")
  return [done[r] for r in range(model_parallel)]
