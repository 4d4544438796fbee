"""The program's spans (``mmt_tpu_torch.utils.timing.span``) on the CPU:
the shared null context when no profiler records, the flag that tells,
the spans a tiny train step and a tiny retrieval eval record under
torch.profiler and how they nest, and that they change no value.  The
trainer's loader-wait spans are held by the profiled trainer run of
tests/test_torch_trainer_switches.py."""

import contextlib

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from mmt_tpu_torch import bench, evaluate
from mmt_tpu_torch.utils import timing

STEP_PHASES = ["mmt.step.forward", "mmt.step.loss", "mmt.step.backward",
               "mmt.step.optimizer"]


def host_spans(prof):
  """[(name, start, end)] of the profiler's host events, by start."""
  return sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()), key=lambda x: (x[1], -x[2]))


def inside(events, outer):
  """The events that lie inside ``outer`` (a (name, start, end))."""
  _, lo, hi = outer
  return [x for x in events if lo <= x[1] and x[2] <= hi and x != outer]


def named(events, prefix):
  return [x for x in events if x[0].startswith(prefix)]


def test_without_a_profiler_a_span_is_the_shared_null_context():
  assert not autograd_profiler._is_profiler_enabled
  first = timing.span("mmt.step")
  assert first is timing.span("mmt.eval")
  assert isinstance(first, contextlib.nullcontext)
  with first:
    pass


def test_the_flag_a_span_reads_is_the_profilers():
  """``span`` reads torch.autograd.profiler._is_profiler_enabled: if a
  torch release renames or stops setting it, this fails rather than the
  spans silently staying off (or on)."""
  assert hasattr(autograd_profiler, "_is_profiler_enabled")
  with profile(activities=[ProfilerActivity.CPU]):
    assert autograd_profiler._is_profiler_enabled
    assert isinstance(timing.span("mmt.step"),
                      autograd_profiler.record_function)
  assert not autograd_profiler._is_profiler_enabled


def test_spanned_waits_each_next_in_a_span():
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    items = list(timing.spanned(iter([3, 1, 2]), "mmt.loader.wait"))
  assert items == [3, 1, 2]
  # Three items and the wait that found the end.
  assert len(named(host_spans(prof), "mmt.loader.wait")) == 4


def stepper():
  model, _, one = bench.train_stepper("cpu", tiny=True, batch_size=4)
  return model, one


@pytest.fixture(scope="module")
def steps():
  """Two steps of the tiny flagship without a profiler, and the same two
  steps from the same state under one: (losses, models, profiler).  One
  thread: the CPU's ``index_put_`` with accumulate (the embedding
  gathers' backward) sums in thread order."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    plain, plain_one = stepper()
    traced, traced_one = stepper()
    plain_losses = [plain_one() for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
      traced_losses = [traced_one() for _ in range(2)]
  finally:
    torch.set_num_threads(threads)
  return (plain_losses, traced_losses), (plain, traced), prof


def test_a_train_step_records_its_phases_in_order(steps):
  events = host_spans(steps[2])
  top = [x for x in events if x[0] == "mmt.step"]
  assert len(top) == 2
  for step in top:
    within = inside(events, step)
    phases = [x for x in within if x[0] in STEP_PHASES]
    assert [x[0] for x in phases] == STEP_PHASES
    forward, loss, backward, optimizer = phases
    assert {x[0] for x in named(inside(within, forward), "mmt.")} == {
        "mmt.tower.text", "mmt.tower.video", "mmt.ffn_op.fwd"}
    assert {x[0] for x in named(inside(within, loss), "mmt.")} == {
        "mmt.similarity"}
    assert {x[0] for x in named(inside(within, backward), "mmt.")} == {
        "mmt.ffn_op.bwd", "mmt.ffn_wgrad"}
    assert named(inside(within, optimizer), "Optimizer.step#")
    # One FFN block a layer of each tower, forward and backward.
    model = steps[1][1]
    layers = (model.txt_bert.cfg.num_hidden_layers
              + model.vid_bert.cfg.num_hidden_layers)
    for name in ("mmt.ffn_op.fwd", "mmt.ffn_op.bwd", "mmt.ffn_wgrad"):
      assert len([x for x in within if x[0] == name]) == layers, name


def test_a_train_step_is_bitwise_the_same_under_the_profiler(steps):
  (plain_losses, traced_losses), (plain, traced), _ = steps
  for a, b in zip(plain_losses, traced_losses):
    assert torch.equal(a, b)
  for (name, p), q in zip(plain.named_parameters(), traced.parameters()):
    assert torch.equal(p, q), name
    assert (p.grad is None) == (q.grad is None), name
    if p.grad is not None:
      assert torch.equal(p.grad, q.grad), name


def test_a_retrieval_eval_records_its_stages_and_changes_no_value():
  model, staged = bench.staged_flagship("cpu", tiny=True, videos=8, chunk=4)
  plain = evaluate.retrieval_eval(model, staged)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    traced = evaluate.retrieval_eval(model, staged)
  assert torch.equal(plain["sims"], traced["sims"])
  assert plain["t2v_metrics"] == traced["t2v_metrics"]
  assert plain["v2t_metrics"] == traced["v2t_metrics"]
  events = host_spans(prof)
  (top,) = [x for x in events if x[0] == "mmt.eval"]
  stages = [x for x in inside(events, top) if x[0].startswith("mmt.eval.")]
  assert [x[0] for x in stages] == ["mmt.eval.embed"] * 2 + [
      "mmt.eval.similarity", "mmt.eval.ranks"]
  embed, sim, ranks = stages[0], stages[2], stages[3]
  assert {x[0] for x in named(inside(events, embed), "mmt.")} == {
      "mmt.tower.text", "mmt.tower.video", "mmt.ffn_op.fwd"}
  assert [x[0] for x in named(inside(events, sim), "mmt.")] == [
      "mmt.similarity"]
  assert [x[0] for x in named(inside(events, ranks), "mmt.")] == [
      "mmt.ranks"] * 2
