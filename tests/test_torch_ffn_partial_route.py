"""Host side of the tensor-parallel train forward's GEMM route (B7).

B7 runs the route of csrc/ffn_block.cu (``launch_route``, the cast pass
and two TMA + wgmma GEMMs) only on the card; which calls take it, the
tile id and scratch ``ffn_train_fwd_partial_cuda`` hands the C entry
point, what it refuses before any launch, and that the tensor-parallel
train block reaches it are plain Python, checked here with operands that
pass for CUDA tensors and a recording stand-in for the launch.
"""

import pytest
import torch

from mmt_tpu_torch.ops import ffn
from mmt_tpu_torch.parallel import TensorParallel
from tests.test_torch_ffn_route import H100_SMS, FakeCuda
from tests.test_torch_ffn_train_route import OnCpu

VIDEO_TOKENS, TEXT_TOKENS = 1 + 7 * (1 + 30), 30   # the flagship's
TP_I = 3072 // 2                                   # I/mp of two ranks
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("rows,h,tile", [
    (32 * VIDEO_TOKENS, 512, 0),   # b32 video 6,976 rows: 55 x 4 = 220 tiles
    (32 * TEXT_TOKENS, 768, 1),    # b32 text 960 rows: 8 x 6 = 48, 15 x 6 = 90
    (1013, 768, 1)])               # ragged
def test_tp_train_shapes_take_the_route_and_these_tiles(rows, h, tile):
  assert ffn.gemm_route(h, TP_I, BF)
  assert ffn.pick_gemm_tile(rows, h, H100_SMS) == tile


def _operands(r=40, h=128, i=256, cd=BF, wrap=OnCpu):
  g = torch.Generator().manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=g)
  ops = dict(x=rand(r, h), w1=rand(i, h).to(cd), b1=rand(i),
             w2=rand(h, i).to(cd))
  return {n: wrap(t) for n, t in ops.items()}


@pytest.fixture
def launches(monkeypatch):
  """Record each C call (entry point name and arguments) instead of
  launching; the library is never built."""
  seen = []
  monkeypatch.setattr(ffn._build, "load_library", lambda: None)
  monkeypatch.setattr(ffn, "_launch",
                      lambda lib, name, dev, *args: seen.append((name, args)))
  monkeypatch.setitem(ffn._SMS, None, H100_SMS)
  return seen


@pytest.mark.parametrize("h,i,cd,tile,want", [
    (128, 256, BF, None, 1),      # the route, picked tile (40 rows)
    (128, 256, BF, 0, 0),         # the route, the tile asked for
    (128, 256, BF, 1, 1),
    (128, 256, BF, -1, -1),       # the WMMA kernel at a route shape
    (192, 768, BF, None, -1),     # off the route: WMMA
    (192, 768, BF, 0, -1),        # off it whatever tile is asked for
    # fp32 on its own route, the 32-row tile (the case keeps the name it
    # had when fp32 ran the FMA kernel).
    pytest.param(128, 256, F32, None, 2, id="128-256-cd6-None--1"),
    (128, 256, F32, -1, -1),      # the FMA kernel at a route shape
    (192, 768, F32, None, -1)])   # fp32 off its route: FMA
def test_wrapper_passes_c_the_tile_and_scratch(h, i, cd, tile, want,
                                               launches):
  r = 40
  before = ffn.ffn_train_fwd_partial_cuda.launches
  out, inter = ffn.ffn_train_fwd_partial_cuda(
      *_operands(r, h, i, cd).values(), compute_dtype=cd, tile=tile)
  assert ffn.ffn_train_fwd_partial_cuda.launches == before + 1
  assert (tuple(out.shape), out.dtype) == ((r, h), F32)
  assert (tuple(inter.shape), inter.dtype) == ((r, i), cd)
  (name, args), = launches
  assert name == "mmt_ffn_train_fwd_partial"
  assert args[4:6] == (out.data_ptr(), inter.data_ptr())
  xb, g = args[6:8]
  assert args[8:11] == (r, h, i) and args[11] == ffn._DTYPE_CODES[cd]
  assert args[12] == want
  if want < 0:
    assert (xb, g) == (None, None)
  elif cd == F32:   # g [R, I] alone: x is fp32 already
    assert xb is None and g is not None
  else:   # one bf16 buffer: xb [R, H], then g [R, I]
    assert g - xb == 2 * r * h


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("misaligned x", "16-byte aligned"),
    ("misaligned b1", "16-byte aligned"),
    ("x not contiguous", "contiguous"),
    ("b1 of the wrong length", "b1 must have shape"),
    ("w2 transposed", "w2 must have shape"),
    ("w1 in fp32", "w1 must be torch.bfloat16"),
    ("x not 2-D", r"rows must be \[R, H\]")])
def test_wrapper_refuses_before_any_launch(case, match, launches):
  before = ffn.ffn_train_fwd_partial_cuda.launches
  ops = _operands(wrap=FakeCuda)
  t = {n: o.t for n, o in ops.items()}
  if case == "cpu":
    ops = t
  elif case == "misaligned x":
    ops["x"] = FakeCuda(t["x"], offset=8)
  elif case == "misaligned b1":
    ops["b1"] = FakeCuda(t["b1"], offset=4)
  elif case == "x not contiguous":
    ops["x"] = FakeCuda(t["x"], contiguous=False)
  elif case == "b1 of the wrong length":
    ops["b1"] = FakeCuda(t["b1"][:-16])
  elif case == "w2 transposed":
    ops["w2"] = FakeCuda(t["w2"].T.contiguous())
  elif case == "w1 in fp32":
    ops["w1"] = FakeCuda(t["w1"].float())
  else:
    ops["x"] = FakeCuda(t["x"].reshape(2, 20, 128))
  with pytest.raises(ValueError, match=match):
    ffn.ffn_train_fwd_partial_cuda(*ops.values(), compute_dtype=BF)
  assert ffn.ffn_train_fwd_partial_cuda.launches == before and not launches


def test_off_the_route_takes_rows_tma_could_not(launches):
  """Only the route needs 16-byte aligned rows: the WMMA kernel at H =
  192 takes x 8 bytes off, as it did before the route."""
  ops = _operands(h=192, i=768)
  ops["x"] = OnCpu(ops["x"].t, offset=8)
  ffn.ffn_train_fwd_partial_cuda(*ops.values(), compute_dtype=BF)
  (_, args), = launches
  assert args[12] == -1


class _GroupOfOne(TensorParallel):
  """A tensor-parallel group of one rank: the all-reduce is a copy."""

  def __init__(self):
    super().__init__(0, 1)

  def all_reduce(self, x):
    return x.to(torch.float32, copy=True)


@pytest.mark.parametrize("h,i,cd,want", [
    (128, 256, BF, 1),       # the route: 40 rows, the 64-row tile
    (192, 768, BF, -1),      # off it: WMMA
    # fp32 on its own route: the 32-row tile (the case keeps the name it
    # had when fp32 ran the FMA kernel).
    pytest.param(128, 256, F32, 2, id="128-256-cd2--1"),
    (192, 768, F32, -1)])    # fp32 off its route: FMA
def test_tp_train_block_launches_b7_with_the_route_tile(h, i, cd, want,
                                                        launches,
                                                        monkeypatch):
  """FFNBlockTrain(tp=) on the kernel path (``ops.use_kernel`` patched,
  the operand checks run on the operands passed off as CUDA tensors)
  launches B7 once, with the tile the deciders give (gemm_route and
  pick_gemm_tile, f32_route and pick_f32_tile), and not B2."""
  check = ffn._check_operands
  monkeypatch.setattr(ffn.ops, "use_kernel", lambda x, family: True)
  monkeypatch.setattr(
      ffn, "_check_operands",
      lambda kernel, *, f32, cd, **kw: check(
          kernel, f32={n: (OnCpu(t), s) for n, (t, s) in f32.items()},
          cd={n: (OnCpu(t), s) for n, (t, s) in cd.items()}, **kw))
  g = torch.Generator().manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=g)
  r = 40
  x, drop = rand(r, h), torch.ones(r, h)
  b7, b2 = (ffn.ffn_train_fwd_partial_cuda.launches,
            ffn.ffn_train_fwd_cuda.launches)
  out = ffn.ffn_block_train(x, drop, rand(i, h), rand(i), rand(h, i),
                            rand(h), torch.ones(h), torch.zeros(h),
                            eps=1e-12, compute_dtype=cd, tp=_GroupOfOne())
  assert tuple(out.shape) == (r, h)
  assert ffn.ffn_train_fwd_partial_cuda.launches == b7 + 1
  assert ffn.ffn_train_fwd_cuda.launches == b2
  (name, args), = launches
  assert name == "mmt_ffn_train_fwd_partial"
  assert args[8:11] == (r, h, i) and args[12] == want
