"""The moonlight caption tower (models/moe_text.py, ops/moe.py) on the CPU
at tiny widths, against the plain reference perfbench/reference/
moe_text.py on seeded random weights.

Tolerances: the program and the reference compute the same fp32
arithmetic in another order (the experts through a sorted grouped layout
against a loop over each expert's tokens, the attention's mask added
against filled), so the widest gap of an output or a gradient is a few
fp32 roundings of its largest value: 1e-5 relative, or 1e-6 absolute on
unit-norm outputs.  The routers' correction biases move by whole steps
of gamma from integer loads, so they are compared exactly.
"""

import json
import pathlib

import pytest
import torch

from mmt_tpu_torch import cli
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.models import moe_text
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import moe as moe_ops
from mmt_tpu_torch.train import losses, optim
from mmt_tpu_torch.train import step as step_lib
from perfbench import checks, inputs
from perfbench.reference import moe_text as ref

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "moonlight" / "activitynet_val1_moonlight.json"
TINY = dict(hidden_size=32, num_hidden_layers=3, intermediate_size=48,
            moe_intermediate_size=16, n_routed_experts=8,
            num_experts_per_tok=3, n_shared_experts=2, num_attention_heads=2,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
            v_head_dim=8, vocab_size=97, experts_held=[0, 1, 2, 3],
            aux_loss_alpha=0.01)
RTOL, OUT_ATOL = 1e-5, 1e-6


def tiny_cfg():
  """The benchmark's moonlight configuration at TINY widths (its MMT side
  cut as perfbench/tests/tiny.py cuts the BERT cells')."""
  cfg = json.loads((REPO / "perfbench" / "configs"
                    / "moonlight-16b-a3b-anet.json").read_text())
  cfg.update(TINY, num_key_value_heads=2, max_text_words=7,
             max_expert_tokens=5, same_dim=16)
  cfg["vid_bert"] = dict(cfg["vid_bert"], hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32)
  cfg["text_bert"] = dict(cfg["text_bert"], vocab_size=TINY["vocab_size"])
  for e in cfg["experts"].values():
    e["dim"] = max(4, e["dim"] // 64)
  return cfg


def weights(cfg, seed=0):
  g = torch.Generator().manual_seed(seed)
  out = {}
  for name, shape, init in ref.param_spec(cfg):
    if init == "zeros":
      out[name] = torch.zeros(shape)
    elif init == "ones":
      out[name] = torch.ones(shape)
    elif init == "count":
      out[name] = torch.zeros(shape, dtype=torch.long)
    else:
      out[name] = torch.randn(shape, generator=g) * init[1]
  return out


def program(cfg, w):
  model = CENet(expert_dims=cfg["experts"], vid_bert_params=cfg["vid_bert"],
                txt_bert_params=cfg["text_bert"], same_dim=cfg["same_dim"],
                device="cpu", text_tower=ref.geometry(cfg),
                **cfg["switches"])
  model.load_state_dict(w, strict=True)
  return model


def rel_gap(a, b):
  return float((a - b).detach().abs().max() / b.detach().abs().max())


@pytest.fixture(autouse=True)
def one_thread():
  # The CPU's embedding backward adds in thread order.
  prev = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(prev)


def test_routing_takes_the_biased_top_k_and_unbiased_weights():
  c = moe_text.TowerConfig.from_dict(TINY)
  layer = moe_text.RoutedMoE(c)
  torch.nn.init.normal_(layer.gate.weight, generator=torch.Generator()
                        .manual_seed(1))
  layer.gate.e_score_correction_bias.copy_(torch.linspace(-0.5, 0.5, 8))
  x = torch.randn(20, 32, generator=torch.Generator().manual_seed(2))
  scores, sel, w, loads = layer.route(x, torch.ones(20))
  s = torch.sigmoid(x @ layer.gate.weight.T)
  biased = s + layer.gate.e_score_correction_bias
  assert torch.equal(sel.sort(1).values,
                     torch.topk(biased, 3, -1).indices.sort(1).values)
  picked = s.gather(1, sel)
  want = picked / (picked.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor
  torch.testing.assert_close(w, want, rtol=0, atol=0)
  assert torch.equal(scores, s)
  assert float(loads.sum()) == 60.0


def test_route_plan_sorts_the_held_experts_first():
  sel = torch.tensor([[0, 5, 2], [7, 1, 0], [2, 3, 6], [1, 0, 4]])
  slot_of = torch.tensor([0, 1, 2, 3, 4, 4, 4, 4])   # 0-3 held
  tok, pos, offsets = moe_ops.route_plan(sel, slot_of, 4)
  assert offsets.tolist() == [0, 3, 5, 7, 8]
  assert sorted(pos.reshape(-1).tolist()) == list(range(12))
  for t in range(4):
    for j in range(3):
      p = int(pos[t, j])
      assert int(tok[p]) == t
      e = int(sel[t, j])
      if e < 4:
        assert offsets[e] <= p < offsets[e + 1]
      else:
        assert p >= offsets[4]


def test_grouped_experts_match_a_loop_and_its_gradients():
  g = torch.Generator().manual_seed(3)
  x = torch.randn(10, 32, generator=g, requires_grad=True)
  sel = torch.topk(torch.rand(10, 8, generator=g), 3, -1).indices
  w = torch.rand(10, 3, generator=g, requires_grad=True)
  w_gu = (0.1 * torch.randn(4, 32, 32, generator=g)).requires_grad_(True)
  w_d = (0.1 * torch.randn(4, 32, 16, generator=g)).requires_grad_(True)
  slot_of = torch.tensor([0, 1, 2, 3, 4, 4, 4, 4])
  dout = torch.randn(10, 32, generator=g)
  out = moe_ops.grouped_experts(x, w, sel, w_gu, w_d, slot_of)
  got = torch.autograd.grad(out, (x, w, w_gu, w_d), dout)
  want_out = torch.zeros(10, 32)
  for t in range(10):
    for j in range(3):
      e = int(sel[t, j])
      if e < 4:
        h = torch.nn.functional.silu(x[t] @ w_gu[e, 0::2].T) * (
            x[t] @ w_gu[e, 1::2].T)
        want_out = want_out.index_add(0, torch.tensor([t]),
                                      (w[t, j] * (h @ w_d[e].T))[None])
  want = torch.autograd.grad(want_out, (x, w, w_gu, w_d), dout)
  assert rel_gap(out, want_out) < RTOL
  for a, b in zip(got, want):
    assert rel_gap(a, b) < RTOL


def test_tower_forward_matches_the_reference():
  cfg = tiny_cfg()
  w = weights(cfg)
  model = program(cfg, w).train(True)
  ids = torch.randint(0, 97, (5, 7), generator=torch.Generator().manual_seed(4))
  mask = torch.ones(5, 7, dtype=torch.long)
  mask[1, 4:] = 0
  pooled, aux = model.txt_tower(ids, mask, train=True)
  chosen = {layer: m.selected for layer, m in zip(
      ref.moe_layers(ref.geometry(cfg)), model.txt_tower.moe_layers())}
  want = ref.tower(w, ref.geometry(cfg), ids, mask, ref.biases_of(w, cfg),
                   chosen)
  assert rel_gap(pooled, want["pooled"]) < RTOL
  assert abs(float(aux) - float(want["aux"])) < RTOL * float(want["aux"])
  assert want["route_gap"] == 0.0


def test_train_steps_match_the_reference():
  """Three steps of the whole CENet with dropout through ``train_step``:
  losses with the balance term, the first step's gradients, the change
  after three Adam steps, the first outputs, the correction biases."""
  cfg = tiny_cfg()
  w = weights(cfg)
  model = program(cfg, w).train(True)
  batches = inputs.make_batches(cfg, [4] * 3, 3, "cpu")
  opt, lr = optim.build_optimizer({"type": "Adam", "args": {
      "lr": 1e-3, "weight_decay": 0}}, model.parameters())
  cfg["optimizer"] = dict(cfg["optimizer"], lr=1e-3)
  gen = torch.Generator().manual_seed(5)
  outputs, seen, chosen = [], [], []
  hook = model.register_forward_hook(lambda m, a, o: outputs.append(
      checks.to_host({k: v for k, v in o.items() if k != "aux_loss"})))
  layers = ref.moe_layers(ref.geometry(cfg))
  moes = model.txt_tower.moe_layers()
  for i, batch in enumerate(batches):
    seen.append(float(step_lib.train_step(
        model, opt, batch, loss_fn=losses.max_margin_ranking_loss(0.05, True),
        lr=lr, generator=gen)))
    chosen.append({l: m.selected.clone() for l, m in zip(layers, moes)})
    if i == 0:
      hook.remove()
      grads = checks.leaf_norms((n, opt.state[p]["exp_avg"] / 0.1)
                                for n, p in model.named_parameters())
  prog = {"losses": seen, "grad_norms": grads, "outputs": outputs[0],
          "change_norms": checks.leaf_norms(
              (n, p.detach() - w[n]) for n, p in model.named_parameters())}
  want = ref.train_steps(lambda n: w[n].clone(), cfg, batches,
                         torch.Generator().manual_seed(5), chosen)
  gaps = checks.train_numbers(prog, want)
  assert gaps["loss_gap"] < RTOL and gaps["grad_gap"] < RTOL
  assert gaps["update_gap"] < 10 * RTOL and gaps["output_gap"] < OUT_ATOL
  assert want["route_gap"] == 0.0
  for layer, m in zip(layers, moes):
    assert torch.equal(m.gate.e_score_correction_bias, want["biases"][layer])
    assert float(m.gate.e_score_correction_bias.abs().sum()) > 0


def test_the_shares_add_up_to_the_uncut_layer():
  """8 experts held in 4 shares of 2: the shares' routed parts, with the
  shared experts counted once, give the reference's whole layer."""
  g = ref.geometry(tiny_cfg())
  g.update(experts_held=None)
  w = weights(dict(tiny_cfg(), experts_held=None))
  pre = f"{ref.TOWER}.layers.1.mlp."
  x = torch.randn(12, 32, generator=torch.Generator().manual_seed(6))
  valid = torch.ones(12)
  bias = torch.zeros(8)
  whole = ref.moe(w, pre, g, x, valid, bias, None)[0]
  shared = ref.swiglu(w[pre + "shared_experts.gate_proj.weight"],
                      w[pre + "shared_experts.up_proj.weight"],
                      w[pre + "shared_experts.down_proj.weight"], x)
  total = shared.clone()
  for share in range(4):
    held = (2 * share, 2 * share + 1)
    c = moe_text.TowerConfig.from_dict(dict(TINY, experts_held=held))
    layer = moe_text.RoutedMoE(c)
    with torch.no_grad():
      layer.gate.weight.copy_(w[pre + "gate.weight"])
      layer.experts_gate_up.copy_(w[pre + "experts_gate_up"][list(held)])
      layer.experts_down.copy_(w[pre + "experts_down"][list(held)])
      for n in ("gate_proj", "up_proj", "down_proj"):
        getattr(layer.shared_experts, n).weight.copy_(
            w[pre + f"shared_experts.{n}.weight"])
    out, _ = layer(x[None], valid[None], False)
    total += out[0] - layer.shared_experts(x)
  assert rel_gap(total, whole) < RTOL


def test_route_gap_reads_zero_and_catches_a_swap():
  g = ref.geometry(tiny_cfg())
  w = weights(tiny_cfg())
  pre = f"{ref.TOWER}.layers.1.mlp."
  x = torch.randn(12, 32, generator=torch.Generator().manual_seed(7))
  bias = torch.zeros(8)
  *_, own, _, gap = ref.moe(w, pre, g, x, torch.ones(12), bias, None)
  assert gap == 0.0
  assert ref.moe(w, pre, g, x, torch.ones(12), bias, own)[4] == 0.0
  biased = torch.sigmoid(x @ w[pre + "gate.weight"].T)
  swapped = own.clone()
  unchosen = [e for e in range(8) if e not in own[0].tolist()]
  worst = min(unchosen, key=lambda e: float(biased[0, e]))
  swapped[0, 0] = worst
  gap = ref.moe(w, pre, g, x, torch.ones(12), bias, swapped)[4]
  assert gap == pytest.approx(float(biased[0, own[0, 0]] - biased[0, worst]))
  assert gap > 0.0


def test_the_tower_refuses_data_and_tensor_parallelism():
  cfg = tiny_cfg()
  model = program(cfg, weights(cfg))
  batch = inputs.make_batches(cfg, [2], 1, "cpu")[0]
  with pytest.raises(ValueError, match="refuses data parallelism"):
    model(batch, train=True, generator=torch.Generator(), dp=object())

  class Two:
    size, rank = 2, 0
  with pytest.raises(ValueError, match="refuses tensor parallelism"):
    CENet(expert_dims=cfg["experts"], vid_bert_params=cfg["vid_bert"],
          same_dim=16, device="cpu", tp=Two(), text_tower=ref.geometry(cfg),
          **cfg["switches"])


def test_two_trainer_steps_from_the_config(tmp_path, monkeypatch):
  """configs/moonlight/'s file at tiny widths on a synthetic corpus:
  ``python -m mmt_tpu_torch.train``'s ``cli.main`` trains one epoch of
  two steps and evaluates (``retrieval_eval``)."""
  data_dir = synthetic.generate(tmp_path, num_videos=12, num_test=4,
                                experts={"s3d": 1024, "vggish": 128},
                                captions_per_video=2)
  monkeypatch.setenv("MMT_TPU_BERT_VOCAB", str(tmp_path / "vocab.txt"))
  cfg = json.loads(CONFIG.read_text())
  args = cfg["arch"]["args"]
  args["text_tower"].update(TINY, vocab_size=400)
  args["vid_bert_params"].update(hidden_size=16, num_hidden_layers=1,
                                 num_attention_heads=2, intermediate_size=32,
                                 max_position_embeddings=8)
  args["same_dim"] = 16
  for key in ("train_sets", "continuous_eval_sets", "final_eval_sets"):
    entry = cfg[key][0]
    entry["args"].update(batch_size=4, num_workers=0)
    entry["args"]["mix"][0].update(
        dataset_name="MSRVTT", cut_name="jsfusion", data_dir=str(data_dir),
        split_name="trainval" if key == "train_sets" else "test",
        max_text_words=6, max_expert_tokens=4)
  cfg.pop("visualizer")
  cfg["trainer"].update(epochs=1, max_samples_per_epoch=8,
                        save_dir=str(tmp_path / "exp"))
  path = tmp_path / "moonlight.json"
  path.write_text(json.dumps(cfg))
  trainer = cli.main(["--config", str(path), "--device", "cpu"])
  assert trainer.n_steps == 2
  assert isinstance(trainer.model.txt_tower, moe_text.MoETextTower)
  rows = sum(int(m.expert_rows.sum())
             for m in trainer.model.txt_tower.moe_layers())
  assert rows > 0
  assert (tmp_path / "exp" / "exp_results.json").exists()
