"""Plain reference of the train step: the train forward, the MoE
similarity merged over each video's captions, the max-margin loss,
autograd's gradients and Adam (torch.optim.Adam's update with weight
decay 0, written out)."""

from __future__ import annotations

import torch

from perfbench.reference import model as ref_model


def _adam(p, grads, state, step, opt):
  b1, b2 = opt["betas"]
  with torch.no_grad():
    for name, g in grads.items():
      m, v = state.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
      m.mul_(b1).add_(g, alpha=1 - b1)
      v.mul_(b2).addcmul_(g, g, value=1 - b2)
      denom = v.sqrt() / (1 - b2 ** step) ** 0.5 + opt["eps"]
      p[name].addcdiv_(m, denom, value=-opt["lr"] / (1 - b1 ** step))


def train_steps(params0, cfg, batches, generator):
  """Train from ``params0`` (not modified) on ``batches``, one step each,
  drawing dropout from ``generator``.  Returns {"losses": [float],
  "grad_norms": {leaf: ||first step's gradient||}, "change_norms":
  {leaf: ||params after the last step - params0||}, "outputs": the first
  step's tower outputs}."""
  opt = cfg["optimizer"]
  if opt["type"] != "Adam" or opt.get("weight_decay", 0):
    raise ValueError(f"the reference's optimizer is Adam without weight "
                     f"decay, not {opt}")
  names = ref_model.trainable(ref_model.param_spec(cfg))
  p = {n: t.detach().clone() for n, t in params0.items()}
  state, losses, grad_norms, outputs = {}, [], None, None
  for step, batch in enumerate(batches, 1):
    leaves = {n: p[n].requires_grad_(True) for n in names}
    out = ref_model.forward(p, cfg, batch, train=True, generator=generator)
    b, k, m, d = out["text_embds"].shape
    sims = ref_model.similarity(out["text_embds"].reshape(b * k, m, d),
                                out["text_weights"].reshape(b * k, m),
                                out["vid_embds"], out["vid_weights"])
    sims = sims.reshape(b, k, -1).mean(1)
    loss = ref_model.max_margin_loss(sims, cfg["loss"]["margin"],
                                     cfg["loss"]["fix_norm"])
    grads = dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))
    for n in names:
      p[n] = p[n].detach()
    if step == 1:
      grad_norms = {n: float(g.norm()) for n, g in grads.items()}
      outputs = {k_: v.detach() for k_, v in out.items()}
    _adam(p, grads, state, step, opt)
    losses.append(float(loss.detach()))
    del out, sims, loss, grads, leaves
  change = {n: float((p[n] - params0[n]).norm()) for n in names}
  return {"losses": losses, "grad_norms": grad_norms,
          "change_norms": change, "outputs": outputs}
