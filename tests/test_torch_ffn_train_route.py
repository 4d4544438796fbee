"""Host side of the FFN train kernels' GEMM route (B2 forward, B3 backward).

The route (csrc/ffn_gemm.cuh plus the row passes of csrc/ffn_block.cu and
csrc/ffn_train_bwd.cu) runs only on the card; which calls take it, the
tile id and scratch the wrappers hand the C entry points, and what they
refuse before any launch are plain Python, checked here with operands
that pass for CUDA tensors and a recording stand-in for the launch.
"""

import importlib.util
import pathlib
import re

import pytest
import torch

from mmt_tpu_torch.ops import ffn
from tests.test_torch_ffn_route import H100_SMS, FakeCuda

REPO = pathlib.Path(__file__).resolve().parents[1]
VIDEO_TOKENS, TEXT_TOKENS = 1 + 7 * (1 + 30), 30   # the flagship's
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("batch,video_tile,text_tile", [
    (32, 0, 1),     # b32: video 55 x 4 = 220 tiles of 128 rows; text 8 x 6
    (128, 0, 0)])   # b128: 218 x 4 = 872; text 30 x 6 = 180
def test_train_shapes_take_the_route_and_these_tiles(batch, video_tile,
                                                     text_tile):
  video, text = batch * VIDEO_TOKENS, batch * TEXT_TOKENS
  assert ffn.gemm_route(512, 3072, BF) and ffn.gemm_route(768, 3072, BF)
  assert ffn.gemm_route(512, 1536, BF)     # a TP rank's I/mp
  assert ffn.pick_gemm_tile(video, 512, H100_SMS) == video_tile
  assert ffn.pick_gemm_tile(text, 768, H100_SMS) == text_tile


def test_b32_text_shape_fills_more_of_the_card_with_64_row_tiles():
  rows, cols = 32 * TEXT_TOKENS, 768 // ffn.GEMM_COLS
  assert rows == 960
  tiles = {t: -(-rows // t) * cols for t in ffn.GEMM_TILES}
  assert tiles == {128: 48, 64: 90}
  assert max(tiles.values()) < H100_SMS


@pytest.mark.parametrize("h,i,dtype,tile,want", [
    (128, 256, BF, 1, 1),         # on the route: the tile asked for
    (128, 256, BF, None, 1),      # picked: 40 rows, one 128-row tile
    (128, 256, BF, -1, -1),       # -1: the WMMA kernel on the route too
    (192, 768, BF, 0, -1),        # off it: -1, whatever tile
    (192, 768, F32, None, -1)])   # fp32: -1 (FMA)
def test_bwd_scratch_holds_dffn_and_both_transposes(h, i, dtype, tile, want,
                                                    monkeypatch):
  monkeypatch.setitem(ffn._SMS, None, H100_SMS)
  buf, dffn, w1t, w2t, got = ffn._bwd_scratch(40, h, i, dtype, tile,
                                              torch.device("cpu"))
  assert got == want
  if want < 0:
    assert (buf, dffn, w1t, w2t) == (None, None, None, None)
  else:
    assert buf.dtype == BF and buf.numel() == 40 * h + 2 * h * i
    assert (dffn, w1t, w2t) == (buf.data_ptr(), buf.data_ptr() + 2 * 40 * h,
                                buf.data_ptr() + 2 * (40 * h + h * i))
    assert all(p % 256 == 0 for p in (w1t - dffn, w2t - dffn))


class OnCpu(FakeCuda):
  """A FakeCuda whose device is the CPU, so that the wrappers' outputs and
  scratch (torch.empty on the operands' device) can be allocated here."""

  def __init__(self, t, **kw):
    super().__init__(t, **kw)
    self.device = torch.device("cpu")


def _train_operands(which, r=40, h=128, i=256, cd=BF):
  g = torch.Generator().manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=g)
  w1, w2 = rand(i, h).to(cd), rand(h, i).to(cd)
  if which == "fwd":
    return dict(x=rand(r, h), drop=rand(r, h), w1=w1, b1=rand(i), w2=w2,
                b2=rand(h), gamma=rand(h), beta=rand(h))
  return dict(dy=rand(r, h), z=rand(r, h).to(cd), inter=rand(r, i).to(cd),
              drop=rand(r, h), w1=w1, w2=w2, gamma=rand(h))


def _call(which, ops, cd=BF, **kw):
  if which == "fwd":
    return ffn.ffn_train_fwd_cuda(*ops.values(), eps=1e-12, compute_dtype=cd,
                                  **kw)
  return ffn.ffn_train_bwd_cuda(*ops.values(), eps=1e-12, compute_dtype=cd,
                                **kw)


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


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("h,i,cd,tile,want", [
    (128, 256, BF, None, 1),      # the route, picked tile
    (128, 256, BF, 0, 0),         # the route, the tile asked for
    (128, 256, BF, -1, -1),       # the WMMA kernel at a route shape
    (192, 768, BF, None, -1),     # off the route: WMMA
    (192, 768, F32, None, -1)])   # fp32: FMA
def test_train_wrappers_pass_c_the_tile_and_scratch(which, h, i, cd, tile,
                                                    want, launches):
  r = 40
  ops = {n: OnCpu(t) for n, t in _train_operands(which, r, h, i, cd).items()}
  kernel = ffn.ffn_train_fwd_cuda if which == "fwd" else ffn.ffn_train_bwd_cuda
  before = kernel.launches
  outs = _call(which, ops, cd, tile=tile)
  assert kernel.launches == before + 1
  (name, args), = launches
  assert name == f"mmt_ffn_train_{which}"
  assert args[-1] == want
  if which == "fwd":
    assert [tuple(o.shape) for o in outs] == [(r, h), (r, i), (r, h)]
    assert [o.dtype for o in outs] == [F32, cd, cd]
    xb, g = args[11:13]
    assert args[13:16] == (r, h, i)
    if want < 0:
      assert (xb, g) == (None, None)
    else:
      assert g - xb == 2 * r * h
  else:
    assert [tuple(o.shape) for o in outs] == [(r, h), (r, h), (r, i)]
    assert [o.dtype for o in outs] == [F32, cd, cd]
    dffn, w1t, w2t = args[10:13]
    assert args[13:16] == (r, h, i) and args[-2] == 1     # add_dz
    if want < 0:
      assert (dffn, w1t, w2t) == (None, None, None)
    else:
      assert (w1t - dffn, w2t - w1t) == (2 * r * h, 2 * h * i)


def test_bwd_wrapper_passes_add_dz_off(launches):
  ops = {n: OnCpu(t) for n, t in _train_operands("bwd").items()}
  _call("bwd", ops, add_dz=False)
  (_, args), = launches
  assert args[-2] == 0 and args[-1] >= 0


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("misaligned rows", "16-byte aligned"),
    ("misaligned mask", "16-byte aligned"),
    ("rows not contiguous", "contiguous")])
def test_train_wrappers_refuse_what_tma_cannot_take(which, case, match,
                                                    launches):
  kernel = ffn.ffn_train_fwd_cuda if which == "fwd" else ffn.ffn_train_bwd_cuda
  before = kernel.launches
  ops = _train_operands(which)
  rows = "x" if which == "fwd" else "dy"
  if case != "cpu":
    ops = {n: FakeCuda(t) for n, t in ops.items()}
    if case == "misaligned rows":
      ops[rows] = FakeCuda(ops[rows].t, offset=8)
    elif case == "misaligned mask":
      ops["drop"] = FakeCuda(ops["drop"].t, offset=4)
    else:
      ops[rows] = FakeCuda(ops[rows].t, contiguous=False)
  with pytest.raises(ValueError, match=match):
    _call(which, ops)
  assert kernel.launches == before and not launches


def test_train_profile_names_kernels_that_exist():
  """chip_smoke.py's train profile finds B2's and B3's kernels by these
  names: each must name a kernel or epilogue of the sources."""
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                REPO / "chip_smoke.py")
  smoke = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(smoke)
  src = "".join(p.read_text() for p in (REPO / "mmt_tpu_torch" / "csrc")
                .iterdir())
  names = [n for kernels in smoke.TRAIN_KERNELS.values() for n in kernels]
  assert set(smoke.TRAIN_KERNELS) == {"ffn_train_fwd", "ffn_train_bwd"}
  for name in names:
    assert re.search(rf"^{name}\(|^struct {name} ", src, re.M), name
  for a in names:
    assert not any(a != b and a in b for b in names), a
