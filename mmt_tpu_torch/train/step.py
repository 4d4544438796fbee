"""One training step of the CENet.

Port of the jitted step of mmt_tpu/train/trainer.py:405-428 (and of
bench.py's train-step bench): the train forward (dropout, batch-stat
BatchNorm), the 'avg'-merged MoE similarity, the loss, the backward and
the optimizer update at the given rate.

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
"""

from __future__ import annotations

from mmt_tpu_torch.models.cenet import similarity_from_outputs
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.utils.timing import span


def train_step(model, optimizer, batch, *, loss_fn, lr, generator, dp=None):
  """One step on ``batch``; returns the loss (a device tensor, not
  synchronised).  ``generator`` draws the dropout masks; ``dp`` is the
  data group (a model group lives in ``model``).  Spans ``mmt.step`` and,
  in it, ``mmt.step.forward``, ``.loss``, ``.backward``, ``.optimizer``."""
  with span("mmt.step"):
    for group in optimizer.param_groups:
      group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    with span("mmt.step.forward"):
      out = model(batch, train=True, generator=generator, dp=dp)
      if dp is not None:
        out = {k: mesh_lib.gather_rows(v, dp) for k, v in out.items()}
    with span("mmt.step.loss"):
      loss = loss_fn(similarity_from_outputs(out, merge="avg"))
    with span("mmt.step.backward"):
      loss.backward()
      if dp is not None:
        mesh_lib.all_reduce_grads(model.parameters(), dp)
    with span("mmt.step.optimizer"):
      optimizer.step()
    return loss.detach()
