"""The loader cell (mix ``trainer``) at test widths on the CPU through
``run.run_cell``: the trainer over ``ExpertDataLoader`` agrees with the
reference on the batches it delivered, a fault planted in the program is
caught, the reference follows the program's hinge terms, and no reader
of another kind reads the cell."""

import json
import time

import pytest
import torch

import mmt_tpu_torch.train.trainer as trainer_lib
from perfbench import run
from perfbench.reference import hinge
from perfbench.reference import model as ref_model

NEW_READERS = ("loader_wait_ms.trainer", "mfu.trainer")
TEXT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, vocab_size=28996, max_position_embeddings=40)
VIDEO = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=32)


@pytest.fixture(autouse=True)
def one_thread():
  prev = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(prev)


def loader_cell(tmp_path, seed=5):
  """msrvtt-train-loader-b32 at test widths: the repository config and
  the cell's configuration cut alike, a corpus of 24 videos."""
  cell = run.Cell("msrvtt-train-loader-b32", seed, "cpu")
  repo = json.loads((run.CHECKOUT / cell.cfg["repo_config"]).read_text())
  arch = repo["arch"]["args"]
  arch["text_bert_geometry"] = TEXT
  arch["vid_bert_params"].update(VIDEO)
  arch["same_dim"] = 16
  path = tmp_path / "repo_config.json"
  path.write_text(json.dumps(repo))
  cell.cfg["repo_config"] = str(path)
  cell.cfg["text_bert"].update(TEXT)
  cell.cfg["vid_bert"].update(VIDEO)
  cell.cfg["same_dim"] = 16
  cell.traffic = dict(cell.traffic, batch=4, videos=24, workers=2,
                      max_feats=8, slice_steps=3)
  return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_the_loader_cell_agrees_with_the_reference(tmp_path, trace):
  result, table = run.run_cell(loader_cell(tmp_path), 0.3, trace,
                               time.time())
  assert result["correct"], table
  assert table["hinge_gap"]["limit"] is not None
  if trace:
    for name in NEW_READERS:
      assert name in result["metrics"]
    # Every reader of another kind reads nothing here.
    assert all(m.endswith(".trainer") for m in result["metrics"]), (
        sorted(result["metrics"]))


def test_a_half_batch_in_the_trainer_is_caught(tmp_path, monkeypatch):
  step = trainer_lib.train_step

  def half(model, opt, batch, **kw):
    cut = {k: ({m: t[:len(t) // 2] for m, t in v.items()}
               if isinstance(v, dict) else v[:len(v) // 2])
           for k, v in batch.items()}
    return step(model, opt, cut, **kw)

  monkeypatch.setattr(trainer_lib, "train_step", half)
  result, table = run.run_cell(loader_cell(tmp_path), 0.3, 0, time.time())
  assert not result["correct"], table


def _sims(seed=0, n=6):
  g = torch.Generator().manual_seed(seed)
  return 0.3 + 0.05 * torch.randn(n, n, generator=g)


def test_following_its_own_similarity_is_the_plain_loss():
  sims = _sims()
  for fix_norm in (True, False):
    loss, gap = hinge.following_loss(sims, sims, 0.05, fix_norm)
    plain = ref_model.max_margin_loss(sims, 0.05, fix_norm)
    assert gap == 0.0
    torch.testing.assert_close(loss, plain, rtol=1e-6, atol=1e-7)


def test_a_term_the_program_counted_on_the_other_side_is_read():
  """A term moved 0.01 across its kink in the program's similarity:
  hinge_gap reads how far the reference's own argument lies from it, and
  the loss counts the term as the program did."""
  sims, margin = _sims(), 0.05
  args = hinge._arguments(sims, margin)[0]
  off = ~torch.eye(len(sims), dtype=torch.bool)
  i, j = divmod(int(torch.where(off, args.abs(), torch.inf).argmin()),
                len(sims))
  program = sims.clone()
  program[i, j] += 0.01 if args[i, j] <= 0 else -0.01
  program_args = hinge._arguments(program, margin)
  assert (program_args[0, i, j] > 0) != (args[i, j] > 0)
  loss, gap = hinge.following_loss(sims, program, margin)
  assert gap == pytest.approx(float(args[i, j].abs()))
  n = len(sims)
  plain = ref_model.max_margin_loss(sims, margin)
  term = float(args[i, j]) / (2.0 * n * (n - 1))
  want = plain + term if args[i, j] <= 0 else plain - term
  torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-7)

