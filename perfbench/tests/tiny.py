"""A benchmark cell cut to test widths, for the CPU tests."""

import copy

from perfbench import run

TRAFFIC = {"train": {"batch": 4, "pool_batches": 4, "check_steps": 3},
           "eval": {"videos": 10, "chunk": 4}}


def tiny_config(cfg):
  cfg = copy.deepcopy(cfg)
  cfg["text_bert"].update(hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          vocab_size=97, max_position_embeddings=40)
  cfg["vid_bert"].update(hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32)
  cfg["same_dim"] = 16
  for e in cfg["experts"].values():
    e["dim"] = max(4, e["dim"] // 64)
  cfg["max_expert_tokens"] = min(cfg["max_expert_tokens"], 5)
  cfg["max_text_words"] = min(cfg["max_text_words"], 7)
  return cfg


def tiny_cell(name, seed=3):
  """The workload ``name`` on the CPU at test widths and sizes."""
  cell = run.Cell(name, seed, "cpu")
  cell.cfg = tiny_config(cell.cfg)
  cell.traffic = dict(cell.traffic, **TRAFFIC[cell.mix.KIND])
  return cell
