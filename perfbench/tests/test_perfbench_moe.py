"""The moonlight tower's cell at test widths on the CPU through
``run.run_cell``: it agrees with the reference, faults planted in the
program are caught, and each new per-layer reader reads nothing of the
other kinds."""

import time

import pytest
import torch

import mmt_tpu_torch.train.step as step_lib
from mmt_tpu_torch.models import moe_text
from perfbench import run
from perfbench.tests.tiny import tiny_cell

TOWER = dict(hidden_size=32, num_hidden_layers=3, intermediate_size=48,
             moe_intermediate_size=16, n_routed_experts=8,
             num_experts_per_tok=3, n_shared_experts=2, num_attention_heads=2,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
             v_head_dim=8, vocab_size=97, experts_held=[0, 1, 2, 3],
             num_key_value_heads=2)
NEW_READERS = ("mfu.train_moe", "idle_share.train_moe",
               "moe_ms_per_step.train_moe", "moe_roofline.train_moe",
               "expert_load_max.train_moe", "matmul_ms_per_step.train_moe",
               "graph_replay_share.train_moe", "host_syncs_per_step.train_moe",
               "ffn_roofline.train_moe", "loader_wait_ms.trainer",
               "mfu.trainer")


@pytest.fixture(autouse=True)
def one_thread():
  prev = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(prev)


def moe_cell(seed=3):
  cell = run.Cell("moonlight-anet-train-b32", seed, "cpu")
  cfg = cell.cfg
  cfg.update(TOWER, max_text_words=7, max_expert_tokens=5, same_dim=16)
  cfg["vid_bert"].update(hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32)
  for e in cfg["experts"].values():
    e["dim"] = max(4, e["dim"] // 64)
  cell.traffic = dict(cell.traffic, batch=4, pool_batches=4, check_steps=3)
  return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_the_moonlight_cell_agrees_with_the_reference(trace):
  result, table = run.run_cell(moe_cell(), 0.2, trace, time.time())
  assert result["correct"], table
  assert table["route_gap"]["value"] == 0.0
  assert table["bias_gap"]["value"] == 0.0
  if trace:
    for name in ("mfu.train_moe", "expert_load_max.train_moe"):
      assert name in result["metrics"]
    # Off the card no kernel runs: the device readers read nothing.
    assert "moe_ms_per_step.train_moe" not in result["metrics"]
    # Every reader of another kind reads nothing here.
    assert all(m.endswith(".train_moe") for m in result["metrics"]), (
        sorted(result["metrics"]))


def test_a_router_that_ignores_its_bias_is_caught(monkeypatch):
  """Routing on s alone (the correction bias left out of the choice)
  passes every other gap but route_gap once the biases have moved."""
  route = moe_text.RoutedMoE.route

  def unbiased(self, x, valid):
    bias = self.gate.e_score_correction_bias
    saved = bias.clone()
    bias.mul_(-1.0)   # the choice runs on s - b
    try:
      return route(self, x, valid)
    finally:
      bias.copy_(saved)

  monkeypatch.setattr(moe_text.RoutedMoE, "route", unbiased)
  cell = moe_cell()
  cell.traffic = dict(cell.traffic, check_steps=4)
  result, table = run.run_cell(cell, 0.2, 0, time.time())
  assert not result["correct"], table


def test_a_half_batch_is_caught(monkeypatch):
  step = step_lib.train_step

  def half(model, opt, batch, **kw):
    cut = {k: ({m: t[:len(t) // 2] for m, t in v.items()}
               if isinstance(v, dict) else v[:len(v) // 2])
           for k, v in batch.items()}
    return step(model, opt, cut, **kw)

  monkeypatch.setattr(step_lib, "train_step", half)
  result, table = run.run_cell(moe_cell(), 0.2, 0, time.time())
  assert not result["correct"], table


@pytest.mark.parametrize("name", ["msrvtt-train-b32", "msrvtt-eval-1k"])
def test_the_new_readers_read_nothing_of_the_other_kinds(name):
  cell = tiny_cell(name)
  result, _ = run.run_cell(cell, 0.1, 1, time.time())
  assert not set(NEW_READERS) & set(result["metrics"])
