"""The per-layer metrics that read the program's spans, each on a slice
made by hand: host spans, device-side annotations and device operations
at known times (seconds on the profiler's clock)."""

import types

import pytest

from perfbench import run, trace

READERS = run.metric_readers()


def make_slice(ops=(), annotations=(), host=()):
  s = trace.Slice.__new__(trace.Slice)
  s.ops, s.annotations, s.host = list(ops), list(annotations), list(host)
  s.span = (0.0, 100.0)
  return s


def reading(kind, slice_, units=2, host_s=(0.05, 0.07)):
  return types.SimpleNamespace(kind=kind, slice=slice_, slice_units=units,
                               window={"host_s": list(host_s)})


def read(name, r):
  return READERS[name].read(r)


def train_slice():
  """Two steps, 10 s apart.  On the host: the step's span and its four
  phases, a tower in the forward, and scalar reads of host tensors.  On
  the device: the towers' annotations (an FFN block's inside the text
  tower's), the loss's, a fill under the backward's own annotation, the
  FFN backward's, torch's optimizer annotation, one op in each phase, and
  copies from and to pageable host memory, in and between the steps."""
  ops, ann, host = [], [], []
  for t in (0.0, 10.0):
    host += [("mmt.step", t, t + 8), ("mmt.step.forward", t + 0.5, t + 3),
             ("mmt.tower.text", t + 0.5, t + 1.5),
             ("mmt.step.loss", t + 3, t + 4),
             ("mmt.step.backward", t + 4, t + 6),
             ("aten::_local_scalar_dense", t + 6.5, t + 6.6),
             ("mmt.step.optimizer", t + 6, t + 7.5)]
    ann += [("mmt.tower.text", t + 1, t + 2),
            ("mmt.ffn_op.fwd", t + 1.2, t + 1.4),
            ("mmt.tower.video", t + 2, t + 3),
            ("mmt.step.loss", t + 3.5, t + 4),
            ("mmt.step.backward", t + 4, t + 4.1),
            ("mmt.ffn_op.bwd", t + 5, t + 5.5),
            ("mmt.ffn_wgrad", t + 5.5, t + 6),
            ("Optimizer.step#Adam.step", t + 8, t + 9)]
    ops += [("embedding", t + 1, t + 1.2), ("ffn_sgemm_kernel", t + 1.2,
                                             t + 1.4),
            ("attention", t + 2.2, t + 2.9), ("loss", t + 3.5, t + 4),
            ("fill", t + 4, t + 4.1), ("index_backward", t + 4.5, t + 5),
            ("ffn_ln_bwd_rows_kernel", t + 5, t + 5.5),
            ("gemm", t + 5.5, t + 6), ("adam", t + 8, t + 9),
            ("Memcpy HtoD (Pageable -> Device)", t + 2, t + 2.1),
            ("Memcpy DtoH (Device -> Pageable)", t + 4.6, t + 4.7),
            ("Memcpy HtoD (Pinned -> Device)", t + 0.1, t + 0.2)]
  ops.append(("Memcpy DtoH (Device -> Pageable)", 9.0, 9.1))  # between
  return make_slice(ops, ann, host)


@pytest.mark.parametrize("phase,host_ms", [("forward", 2.5 / 8 * 60),
                                           ("backward", 2 / 8 * 60),
                                           ("optimizer", 1.5 / 8 * 60)])
def test_host_phases_scale_their_share_by_the_untraced_window(phase,
                                                              host_ms):
  """A phase's share of the ``mmt.step`` spans' host seconds, times the
  window's mean host ms a call (50 and 70 ms: 60)."""
  r = reading("train", train_slice())
  assert read(f"{phase}_host_ms_per_step.train", r) == pytest.approx(host_ms)


def test_forward_reads_the_towers_and_the_spans_nested_in_them():
  """``mmt.step.forward`` launches nothing itself and has no annotation:
  the towers' (1-2 and 2-3 s a step) hold the forward's ops and the video
  tower's copy, 1.2 s a step, the FFN block's counted once."""
  r = reading("train", train_slice())
  assert read("forward_ms_per_step.train", r) == pytest.approx(1e3 * 1.2)


def test_backward_follows_the_stream_from_the_loss_to_the_optimizer():
  """The backward's own annotation holds only the fill its thread
  launched (0.1 s); the backward reads every op between the loss's
  annotation and the optimizer's: fill, index backward, B3, weight
  gradients, 1.6 s a step."""
  r = reading("train", train_slice())
  assert read("backward_ms_per_step.train", r) == pytest.approx(1e3 * 1.6)


def test_ffn_reads_both_directions_and_not_the_weight_gradients():
  r = reading("train", train_slice())
  assert read("ffn_ms_per_step.train", r) == pytest.approx(1e3 * 0.7)


def test_host_syncs_count_pageable_copies_inside_the_steps_only():
  """Two a step; not the pinned copy, which the host does not wait for,
  nor the host's scalar reads, nor the copy between the steps."""
  r = reading("train", train_slice())
  assert read("host_syncs_per_step.train", r) == 2


def eval_slice():
  ops = [("b1", 1, 2), ("moe_similarity_kernel", 3, 3.5),
         ("Memcpy DtoH (Device -> Pageable)", 4, 4.1), ("ranks", 4.2, 4.8),
         ("Memcpy DtoH (Device -> Pageable)", 4.9, 5),
         ("Memcpy DtoH (Device -> Pageable)", 7, 7.05)]
  ann = [("mmt.ffn_op.fwd", 1, 2), ("mmt.eval.similarity", 3, 3.5),
         ("mmt.eval.ranks", 4, 5), ("mmt.ranks", 4.2, 4.8)]
  host = [("mmt.eval", 0, 6), ("mmt.eval.ranks", 3.9, 6),
          ("aten::_local_scalar_dense", 4.9, 5.2),
          ("aten::_local_scalar_dense", 7, 7.1)]
  return make_slice(ops, ann, host)


def test_the_eval_driver_reads_its_ranks_ffn_and_syncs():
  r = reading("eval", eval_slice(), units=1)
  assert read("rank_ms_per_eval.eval", r) == pytest.approx(1e3 * 0.8)
  assert read("ffn_ms_per_eval.eval", r) == pytest.approx(1e3 * 1.0)
  assert read("host_syncs_per_eval.eval", r) == 2


SPAN_READERS = ["forward_host_ms_per_step.train",
                "backward_host_ms_per_step.train",
                "optimizer_host_ms_per_step.train",
                "forward_ms_per_step.train", "backward_ms_per_step.train",
                "host_syncs_per_step.train", "ffn_ms_per_step.train",
                "ffn_ms_per_eval.eval", "rank_ms_per_eval.eval",
                "host_syncs_per_eval.eval"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_none_without_the_spans_and_none_off_the_card(name):
  kind = name.rsplit(".", 1)[1]
  full = train_slice() if kind == "train" else eval_slice()
  assert read(name, reading(kind, full)) is not None
  # A program without spans: the same ops and host ops, no mmt.* names.
  bare = make_slice(full.ops, [a for a in full.annotations
                               if not a[0].startswith("mmt.")],
                    [h for h in full.host if not h[0].startswith("mmt.")])
  assert read(name, reading(kind, bare)) is None
  # Off the card: the spans, and no device op.
  assert read(name, reading(kind, make_slice((), (), full.host))) is None
  # The other kind's cells.
  other = "eval" if kind == "train" else "train"
  assert read(name, reading(other, full)) is None
