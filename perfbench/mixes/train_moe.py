"""The training program at the moonlight caption tower: ``train_step`` of
mmt_tpu_torch's CENet with ``txt_agg`` "moonlight" over a pool of distinct
batches staged on the device, one step after another, as
``mixes/train.py`` drives the BERT configurations.

Traffic parameters: those of ``mixes/train.py`` (``batch``,
``captions_per_video``, ``pool_batches``, ``check_steps``).

What differs from ``mixes/train.py``:

- the weights are drawn leaf by leaf, each from a generator of its own
  seeded from the run's seed and the leaf's place in the reference's
  ``param_spec``, so that one leaf can be drawn again alone: the change
  of every leaf after the checked steps, and the reference's start, take
  a leaf's initial value that way, and no device copy of the 12 GB of
  initial weights is kept through the window;
- the checked steps also keep each MoE layer's choices (the program's
  ``selected``) and, after the last, the routers' correction biases; the
  reference follows those choices and reports ``route_gap``, and
  ``bias_gap`` is the widest gap of the biases (``reference/moe_text.py``
  says why);
- the window and the slice read the MoE layers' device row counters
  (``expert_rows``) before and after, for ``mfu.train_moe``,
  ``moe_roofline.train_moe`` and ``expert_load_max.train_moe``.
"""

from __future__ import annotations

import dataclasses

import torch

from mmt_tpu_torch.models import moe_text
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.train import losses as losses_lib
from mmt_tpu_torch.train import optim as optim_lib
from mmt_tpu_torch.train import step as step_lib
from perfbench import checks, inputs, moe_flops
from perfbench.mixes import train as train_mix
from perfbench.reference import model as ref_model
from perfbench.reference import moe_text as ref

KIND = "train_moe"
SLICE_STEPS = 2
# The keys of a configuration file the program's tower reads: its
# geometry's fields, the source's keys it checks and those it records.
TOWER_KEYS = ({f.name for f in dataclasses.fields(moe_text.TowerConfig)}
              | set(moe_text.FIXED) | set(moe_text.RECORDED))


def tower_config(cfg):
  return {k: v for k, v in cfg.items() if k in TOWER_KEYS}


def unit_flops(cell):
  t = cell.traffic
  return moe_flops.train_step_flops(cell.cfg, t["batch"],
                                    t["captions_per_video"])


def ffn_calls(cell):
  """B2 and B3 in each layer of the video tower (the caption tower has no
  FFN block)."""
  v = cell.cfg["vid_bert"]
  rows = cell.traffic["batch"] * moe_flops.flops.video_tokens(cell.cfg)
  return [(k, rows, v["hidden_size"], v["intermediate_size"])
          for _ in range(v["num_hidden_layers"]) for k in ("B2", "B3")]


def leaf(cfg, seed, device, index, name, shape, init):
  """One parameter or buffer of ``param_spec`` as drawn from the seed."""
  if init == "zeros":
    return torch.zeros(shape, device=device)
  if init == "ones":
    return torch.ones(shape, device=device)
  if init == "count":
    return torch.zeros(shape, dtype=torch.long, device=device)
  g = torch.Generator(device=device).manual_seed(
      (int(seed) * 1_000_003 + 7 * index + 1) % 2 ** 63)
  return torch.randn(shape, generator=g, device=device) * init[1]


def initial(cfg, seed, device):
  """name -> that leaf's initial value (drawn anew each call)."""
  spec = {name: (i, shape, init)
          for i, (name, shape, init) in enumerate(ref.param_spec(cfg))}
  return lambda name: leaf(cfg, seed, device, spec[name][0], name,
                           *spec[name][1:])


def batches(cfg, t, seed, device):
  text = dict(cfg["text_bert"], vocab_size=cfg["vocab_size"])
  return inputs.make_batches(dict(cfg, text_bert=text),
                             [t["batch"]] * t["pool_batches"], seed, device,
                             t["captions_per_video"])


def build_model(cfg, init, device):
  """The program's CENet at ``cfg`` holding the weights ``init`` gives;
  every name and shape of its state dict must be the reference's."""
  model = CENet(expert_dims=cfg["experts"], vid_bert_params=cfg["vid_bert"],
                txt_bert_params=cfg["text_bert"], same_dim=cfg["same_dim"],
                compute_dtype=torch.float32, device=device,
                text_tower=tower_config(cfg), **cfg["switches"])
  state = model.state_dict(keep_vars=True)
  spec = {name: shape for name, shape, _ in ref.param_spec(cfg)}
  if {k: tuple(v.shape) for k, v in state.items()} != spec:
    raise ValueError("the program's parameters are not the reference's: "
                     f"{sorted(set(state) ^ set(spec))}")
  with torch.no_grad():
    for name, t in state.items():
      t.copy_(init(name))
  return model


class State:
  """The step object the set-up builds and the window drives."""

  def __init__(self, cell):
    cfg, t, dev = cell.cfg, cell.traffic, cell.device
    self.cell = cell
    self.init = initial(cfg, cell.seed, dev)
    self.model = build_model(cfg, self.init, dev).train(True)
    self.moe = self.model.txt_tower.moe_layers()
    self.layers = ref.moe_layers(ref.geometry(cfg))
    o = cfg["optimizer"]
    self.optimizer, self.lr = optim_lib.build_optimizer(
        {"type": o["type"], "args": {"lr": o["lr"],
                                     "weight_decay": o["weight_decay"],
                                     "betas": o["betas"], "eps": o["eps"]}},
        self.model.parameters())
    self.loss_fn = losses_lib.max_margin_ranking_loss(
        cfg["loss"]["margin"], cfg["loss"]["fix_norm"])
    self.generator = inputs.generator(cell.seed, inputs.DROPOUT, dev)
    self.pool = batches(cfg, t, cell.seed, dev)
    self.taken = 0
    self.checked = self._checked_steps(t["check_steps"])

  def step(self):
    batch = self.pool[self.taken % len(self.pool)]
    self.taken += 1
    return step_lib.train_step(self.model, self.optimizer, batch,
                               loss_fn=self.loss_fn, lr=self.lr,
                               generator=self.generator)

  def rows(self):
    """The MoE layers' row counters [layers, n_experts], a device copy."""
    return torch.stack([m.expert_rows for m in self.moe]).clone()

  def _checked_steps(self, n):
    """The first ``n`` steps, through ``step``: train.py's readings, each
    step's choices by MoE layer and the correction biases after the n."""
    outputs = []
    hook = self.model.register_forward_hook(
        lambda mod, args, out: outputs.append(checks.to_host(
            {k: v for k, v in out.items() if k != "aux_loss"})))
    losses, grads, chosen = [], None, []
    beta1 = self.cell.cfg["optimizer"]["betas"][0]
    for i in range(n):
      losses.append(self.step())
      chosen.append({layer: m.selected.to("cpu", copy=True)
                     for layer, m in zip(self.layers, self.moe)})
      if i == 0:
        hook.remove()
        state = self.optimizer.state
        grads = checks.leaf_norms(
            (name, state[p]["exp_avg"] / (1 - beta1))
            for name, p in self.model.named_parameters() if p in state
            and "exp_avg" in state[p])
    change = checks.leaf_norms((name, p.detach() - self.init(name))
                               for name, p in self.model.named_parameters())
    return {"losses": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": change, "outputs": outputs[0], "chosen": chosen,
            "biases": {layer: m.gate.e_score_correction_bias.to(
                "cpu", copy=True)
                       for layer, m in zip(self.layers, self.moe)}}


def setup(cell):
  return State(cell)


def window(state, seconds, sync):
  """``mixes/train.py``'s window, and "held_rows": the rows the MoE layers
  sent to held experts in it."""
  before = state.rows()
  win = train_mix.window(state, seconds, sync)
  win["held_rows"] = sum(moe_flops.steps_rows(state.cell.cfg,
                                              (state.rows() - before).cpu()))
  return win


def end_to_end(cell, win):
  return train_mix.end_to_end(cell, win)


def slice_work(state):
  """(the work a profiler slice records, the steps it takes); the MoE
  layers' row counters before and after it land on the cell as
  ``moe_slice_rows`` [layers, n_experts] (host), for the readers."""
  def work():
    before = state.rows()
    for _ in range(SLICE_STEPS):
      state.step()
    state.cell.moe_slice_rows = (state.rows() - before).cpu()

  return work, SLICE_STEPS


def results(state):
  """What the check compares; frees the program's state.  The choices
  also go to the cell, for the reference to follow."""
  out = state.checked
  state.cell.program_choices = out["chosen"]
  del state.model, state.optimizer, state.pool, state.moe
  return out


def reference(cell, tf32=False, transform=None):
  """The reference's readings of the checked steps, from the seed,
  following the choices of what ran in the program's place (the
  program's, or those of the first reference run, such as the control's,
  which routes on its own); with ``tf32`` in TF32 and with ``transform``
  on each batch (the control and the faults)."""
  t, dev = cell.traffic, cell.device
  pool = batches(cell.cfg, t, cell.seed, dev)[:t["check_steps"]]
  pool = [transform(b) for b in pool] if transform else pool
  choices = getattr(cell, "program_choices", None)
  chosen = None
  tokens = [b["token_ids"][..., 0].numel() for b in pool]
  fit = choices is None or all(c.shape[0] == n for step, n in
                               zip(choices, tokens) for c in step.values())
  if choices is not None and fit:
    chosen = [{layer: c.to(dev) for layer, c in step.items()}
              for step in choices]
  gen = inputs.generator(cell.seed, inputs.DROPOUT, dev)
  with ref_model.precision(tf32):
    out = ref.train_steps(initial(cell.cfg, cell.seed, dev), cell.cfg, pool,
                          gen, chosen)
  out["outputs"] = checks.to_host(out["outputs"])
  out["biases"] = {k: v.cpu() for k, v in out["biases"].items()}
  if choices is None:
    cell.program_choices = [{k: v.cpu() for k, v in step.items()}
                            for step in out["chosen"]]
  out["choices_fit"] = fit
  return out


def numbers(prog, ref_out):
  """``checks.train_numbers``, ``route_gap`` (the reference's reading of
  the choices it followed; infinite where the program's choices were not
  made for the reference's tokens, as under the half-batch fault) and
  ``bias_gap`` (the widest gap of the routers' correction biases after
  the checked steps)."""
  return {**checks.train_numbers(prog, ref_out),
          "route_gap": (ref_out["route_gap"] if ref_out["choices_fit"]
                        else float("inf")),
          "bias_gap": max(float((prog["biases"][k] - v).abs().max())
                          for k, v in ref_out["biases"].items())}
