"""One training step of the CENet.

Port of the jitted step of mmt_tpu/train/trainer.py:405-428 (and of
bench.py's train-step bench): the train forward (dropout, batch-stat
BatchNorm), the 'avg'-merged MoE similarity, the loss, the backward and
the optimizer update at the given rate.  A model whose train forward
returns an ``aux_loss`` (CENet's moonlight tower: its routers' balance
loss) has it added to the loss, and the model's ``post_step`` (the
routers' correction biases) runs after the update, inside the step.

With a ``dp`` (``parallel.DataParallel``) the batch is this rank's rows
of the global batch, and the step is the single-device step on that
batch (the JAX step under its data mesh): the forward draws the global
batch's dropout masks and BatchNorm moments, the outputs are gathered
(``parallel.gather_rows``), every rank takes the same [B, B] similarity
and loss (global-batch negatives), and the gradients, each rank's share
through its rows, are summed over the ranks (``parallel.all_reduce_grads``)
before the optimizer, so every optimizer sees the same gradients on every
rank.

A model split over a model group (``CENet(tp=)``, data x tensor
parallelism) takes the same step with ``dp`` its DATA group: the outputs
are gathered and the gradients summed over the data group only.  Under
Megatron's f and g every model rank already holds the whole gradient of
each replicated parameter and its own shard's of each split one;
summing over the model group too would give M x the gradient.

On the card the whole step is replayed as one CUDA graph where the call
allows it (``graph_eligible``: batch on the card, one device, Adam or
AdamW, no module hook, anomaly mode off), so the host no longer launches
its kernels one by one.  Per model and batch signature (keys, shapes,
dtypes, devices, and the kernel families and TF32 flags in force) the
first such call runs eagerly as the warm-up, the next captures the step
and replays it, later ones copy the batch into the graph's inputs and
replay.  The
same kernels run, the dropout generator advances as the eager step
advances it (``register_generator_state``), parameters, Adam's moments
and BatchNorm's buffers are updated in place; Adam / AdamW run with
``capturable=True`` and their rate is a device tensor each call fills
(``make_capturable``), from the first eligible call on.  Every other call
runs eagerly.  The kernel wrappers' ``launches`` counters move on a
replay by what the capture counted, so they keep counting the launches
that ran; ``train_step.captures``, ``.replays`` and ``.eager_steps``
count the calls of each kind.
"""

from __future__ import annotations

import itertools
import weakref

import torch

from mmt_tpu_torch import ops
from mmt_tpu_torch.models.cenet import similarity_from_outputs
from mmt_tpu_torch.ops import ffn as ffn_ops
from mmt_tpu_torch.ops import moe as moe_ops
from mmt_tpu_torch.ops import ranking as ranking_ops
from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.utils.timing import span

# Batch signatures a model keeps a graph for; a call at a further one
# runs eagerly.
GRAPHS_PER_MODEL = 2
# The optimizers whose update a graph may hold (their capturable mode).
GRAPH_OPTIMIZERS = (torch.optim.Adam, torch.optim.AdamW)
# The kernel wrappers whose ``launches`` count their kernels (B1, B2, B3,
# B6, B7, B4, B5, the grouped expert GEMMs), by module and name: looked up
# at each capture.
COUNTED = ((ffn_ops, "ffn_block_cuda"), (ffn_ops, "ffn_train_fwd_cuda"),
           (ffn_ops, "ffn_train_bwd_cuda"), (ffn_ops, "ffn_partial_cuda"),
           (ffn_ops, "ffn_train_fwd_partial_cuda"),
           (similarity_ops, "sim_cuda"), (ranking_ops, "fused_counts_cuda"),
           (moe_ops, "moe_grouped_cuda"))

_GRAPHS = weakref.WeakKeyDictionary()   # model -> StepGraphs
_NEW = object()


def train_step(model, optimizer, batch, *, loss_fn, lr, generator, dp=None):
  """One step on ``batch``; returns the loss (a device tensor of its own,
  not synchronised).  ``generator`` draws the dropout masks; ``dp`` is
  the data group (a model group lives in ``model``).  Spans ``mmt.step``
  and, in it, ``mmt.step.forward``, ``.loss``, ``.backward``,
  ``.optimizer`` on an eager call, ``mmt.step.graph`` around a replay."""
  with span("mmt.step"):
    if graph_eligible(model, optimizer, batch, generator, dp):
      return _graphs_for(model, optimizer, loss_fn, generator,
                         batch).step(model, optimizer, batch, lr)
    graphs = _GRAPHS.get(model)
    if graphs is not None:
      graphs.current = None   # this step's gradients replace a graph's
    for group in optimizer.param_groups:
      if torch.is_tensor(group["lr"]):   # capturable (``make_capturable``)
        group["lr"].fill_(lr)
      else:
        group["lr"] = lr
    _counts.eager_steps += 1
    return _step(model, optimizer, batch, loss_fn, generator, dp).detach()


train_step.captures = 0
train_step.replays = 0
train_step.eager_steps = 0
# The function that holds the counters, for the code below: a caller may
# wrap ``train_step`` under its name (the benchmark's faults do).
_counts = train_step


def _step(model, optimizer, batch, loss_fn, generator, dp):
  """Forward, loss, backward and update; the loss."""
  optimizer.zero_grad(set_to_none=True)
  with span("mmt.step.forward"):
    out = model(batch, train=True, generator=generator, dp=dp)
    if dp is not None:
      out = {k: mesh_lib.gather_rows(v, dp) for k, v in out.items()}
  with span("mmt.step.loss"):
    loss = loss_fn(similarity_from_outputs(out, merge="avg"))
    if "aux_loss" in out:
      loss = loss + out["aux_loss"]
  with span("mmt.step.backward"):
    loss.backward()
    if dp is not None:
      mesh_lib.all_reduce_grads(model.parameters(), dp)
  with span("mmt.step.optimizer"):
    optimizer.step()
    post_step = getattr(model, "post_step", None)
    if post_step is not None:
      post_step()
  return loss


def _leaves(batch, path=()):
  """[(path, value)] of the batch's leaves, through dicts (sorted keys),
  lists and tuples."""
  if isinstance(batch, dict):
    return [leaf for k in sorted(batch) for leaf in
            _leaves(batch[k], path + (k,))]
  if isinstance(batch, (list, tuple)):
    return [leaf for i, v in enumerate(batch) for leaf in
            _leaves(v, path + (i,))]
  return [(path, batch)]


def _hooked(model):
  """True if a forward or backward hook (global, or on any module of
  ``model``) would run Python inside the step.  The modules are listed
  once a model has graphs (walking them anew costs more)."""
  glob = torch.nn.modules.module
  if (glob._global_forward_hooks or glob._global_forward_pre_hooks
      or glob._global_backward_hooks or glob._global_backward_pre_hooks):
    return True
  graphs = _GRAPHS.get(model)
  modules = (model.modules() if graphs is None
             else itertools.chain((model,), graphs.submodules))
  return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
             or m._backward_pre_hooks for m in modules)


def graph_eligible(model, optimizer, batch, generator, dp):
  """True if a step on ``batch`` may run as a replayed CUDA graph: every
  batch tensor on one CUDA device, no data group and no model group, an
  Adam or AdamW optimizer, a CUDA generator (or none), autograd's
  anomaly mode off and no hook on the model."""
  tensors = [v for _, v in _leaves(batch) if torch.is_tensor(v)]
  return (bool(tensors) and tensors[0].is_cuda
          and all(t.device == tensors[0].device for t in tensors)
          and dp is None and getattr(model, "tp", None) is None
          and type(optimizer) in GRAPH_OPTIMIZERS
          and (generator is None or generator.device.type == "cuda")
          and not torch.is_anomaly_enabled() and not _hooked(model))


def make_capturable(optimizer, device):
  """Switch Adam / AdamW's groups to ``capturable=True`` with one 0-dim
  fp32 rate tensor on ``device`` (returned; a step fills it), and move
  their step counts to their parameters' devices."""
  lr = torch.zeros((), device=device)
  # Eager steps at capturable=True are meant (the warm-up): torch's
  # once-per-optimizer warning about them is taken as given.
  optimizer._warned_capturable_if_run_uncaptured = True
  for group in optimizer.param_groups:
    group["capturable"] = True
    group["lr"] = lr
    for p in group["params"]:
      state = optimizer.state.get(p)
      if state and "step" in state:
        state["step"] = state["step"].to(p.device)
  return lr


def portable_optimizer_state(state):
  """``optimizer.state_dict()`` in its eager form, as a checkpoint keeps
  it: a capturable group's rate as a float, ``capturable`` off and the
  step counts on the host (a later ``train_step`` on the card switches
  them back)."""
  groups = [dict(g, lr=float(g["lr"]), capturable=False)
            if g.get("capturable") else g for g in state["param_groups"]]
  per_param = {k: dict(s, step=s["step"].cpu())
               if torch.is_tensor(s.get("step")) else s
               for k, s in state["state"].items()}
  return dict(state, state=per_param, param_groups=groups)


class StepGraph:
  """One captured step: the CUDA graph, its input tensors (the batch's
  leaves in ``_leaves`` order), its loss, the gradients it writes
  [(parameter, tensor)], and the launch counters the capture moved
  [(wrapper, launches)]."""

  def __init__(self, graph, inputs, loss, grads, launched):
    self.graph, self.inputs, self.loss = graph, inputs, loss
    self.grads, self.launched = grads, launched

  def replay(self, tensors, count=True):
    """Copy ``tensors`` into the inputs (on the stream), replay, and with
    ``count`` move each counter by its captured launches; returns a copy
    of the loss (callers keep the losses of several steps)."""
    for dst, src in zip(self.inputs, tensors):
      dst.copy_(src)
    with span("mmt.step.graph"):
      self.graph.replay()
    if count:
      for wrapper, n in self.launched:
        wrapper.launches += n
    _counts.replays += 1
    return self.loss.clone()


class StepGraphs:
  """The graphs of one model with one optimizer, loss and generator, by
  batch signature: None once the warm-up ran, then its ``StepGraph``."""

  def __init__(self, model, optimizer, loss_fn, generator, device):
    self.optimizer, self.loss_fn, self.generator = optimizer, loss_fn, generator
    self.device = device
    # Not the model itself: _GRAPHS holds it weakly.
    self.submodules = list(model.modules())[1:]
    self.lr = make_capturable(optimizer, device)
    self.state = optimizer.state   # a loaded state_dict replaces it
    self.graphs = {}
    self.current = None   # the StepGraph whose gradients the model holds

  def bound_to(self, optimizer, loss_fn, generator):
    return (optimizer is self.optimizer and loss_fn is self.loss_fn
            and generator is self.generator and optimizer.state is self.state
            and all(g["lr"] is self.lr and g.get("capturable")
                    for g in optimizer.param_groups))

  def step(self, model, optimizer, batch, lr):
    """The warm-up (eager), the capture and replay, or a replay of the
    step at ``batch``'s signature; eager beyond GRAPHS_PER_MODEL."""
    leaves = _leaves(batch)
    key = (tuple((path, tuple(v.shape), v.dtype, v.device)
                 if torch.is_tensor(v) else (path, v) for path, v in leaves),
           tuple(ops.kernel_families(self.device).items()),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    self.lr.fill_(lr)
    try:
      graph = self.graphs.get(key, _NEW)
    except TypeError:   # a leaf that is no tensor and cannot be hashed
      graph, key = _NEW, None
    with torch.cuda.device(self.device):
      if graph is _NEW:
        if key is not None and len(self.graphs) < GRAPHS_PER_MODEL:
          self.graphs[key] = None   # captured at the next call
        self.current = None
        _counts.eager_steps += 1
        return _step(model, optimizer, batch, self.loss_fn, self.generator,
                     None).detach()
      # The capture's own launches were counted as it recorded them.
      count = graph is not None
      if graph is None:
        graph = self.graphs[key] = self._capture(model, optimizer, batch)
      if self.current is not graph:
        for p, g in graph.grads:
          p.grad = g
        self.current = graph
      return graph.replay([v for _, v in leaves if torch.is_tensor(v)],
                          count)

  def _capture(self, model, optimizer, batch):
    """Capture one step on a copy of ``batch``, which becomes the graph's
    inputs; nothing runs until the graph is replayed."""
    static = _map(batch, torch.Tensor.clone)
    inputs = [v for _, v in _leaves(static) if torch.is_tensor(v)]
    # The graph's private pool is filled from memory the caching allocator
    # does not hold, and entering the capture empties its cache: the
    # warm-up's gradients go first, so that their memory is given back too
    # (a model that fills most of the card needs it).
    optimizer.zero_grad(set_to_none=True)
    counters = [getattr(mod, name) for mod, name in COUNTED]
    before = [c.launches for c in counters]
    graph = torch.cuda.CUDAGraph()
    if self.generator is not None:
      graph.register_generator_state(self.generator)
    with torch.cuda.graph(graph):
      loss = _step(model, optimizer, static, self.loss_fn, self.generator,
                   None).detach()
    launched = [(c, c.launches - n) for c, n in zip(counters, before)
                if c.launches != n]
    grads = [(p, p.grad) for p in model.parameters() if p.grad is not None]
    _counts.captures += 1
    return StepGraph(graph, inputs, loss, grads, launched)


def _map(batch, fn):
  """``batch`` with ``fn`` applied to each tensor leaf."""
  if isinstance(batch, dict):
    return {k: _map(v, fn) for k, v in batch.items()}
  if isinstance(batch, (list, tuple)):
    return type(batch)(_map(v, fn) for v in batch)
  return fn(batch) if torch.is_tensor(batch) else batch


def _graphs_for(model, optimizer, loss_fn, generator, batch):
  """``model``'s StepGraphs, made anew when the optimizer, loss, generator
  or the optimizer's state or groups are not those its graphs hold."""
  graphs = _GRAPHS.get(model)
  if graphs is None or not graphs.bound_to(optimizer, loss_fn, generator):
    device = next(v for _, v in _leaves(batch) if torch.is_tensor(v)).device
    graphs = _GRAPHS[model] = StepGraphs(model, optimizer, loss_fn,
                                         generator, device)
  return graphs
