"""One training step of the CENet.

Port of the jitted step of mmt_tpu/train/trainer.py:405-428 (and of
bench.py's train-step bench): the train forward (dropout, batch-stat
BatchNorm), the 'avg'-merged MoE similarity, the loss, the backward and
the optimizer update at the given rate.
"""

from __future__ import annotations

from mmt_tpu_torch.models.cenet import similarity_from_outputs


def train_step(model, optimizer, batch, *, loss_fn, lr, generator):
  """One step on ``batch``; returns the loss (a device tensor, not
  synchronised).  ``generator`` draws the dropout masks."""
  for group in optimizer.param_groups:
    group["lr"] = lr
  optimizer.zero_grad(set_to_none=True)
  out = model(batch, train=True, generator=generator)
  loss = loss_fn(similarity_from_outputs(out, merge="avg"))
  loss.backward()
  optimizer.step()
  return loss.detach()
