"""Host side of the eval FFN block's GEMM route (B1, B6).

The route itself (csrc/ffn_gemm.cuh: TMA + wgmma) runs only on the card;
what decides whether a call takes it, which tile it runs, what the
wrappers refuse, and whether the ctypes signatures match the C entry
points is plain Python and source text, checked here.
"""

import json
import pathlib
import re

import pytest
import torch

from mmt_tpu_torch import _build
from mmt_tpu_torch.config import TEXT_BERT_BASE_CASED
from mmt_tpu_torch.ops import ffn

REPO = pathlib.Path(__file__).resolve().parents[1]
H100_SMS = 132
CHUNK = 50     # eval chunk: videos (captions) per forward
VIDEO_TOKENS, TEXT_TOKENS = 1 + 7 * (1 + 30), 30   # the flagship's


def _config_widths():
  """(H, I) of every FFN of configs/eccv20/: each config's video tower and
  the bert-base-cased text tower."""
  widths = {(TEXT_BERT_BASE_CASED.hidden_size,
             TEXT_BERT_BASE_CASED.intermediate_size)}
  for path in sorted((REPO / "configs" / "eccv20").glob("*.json")):
    vid = json.loads(path.read_text())["arch"]["args"]["vid_bert_params"]
    widths.add((vid["hidden_size"], vid["intermediate_size"]))
  return sorted(widths)


def test_every_config_width_takes_the_gemm_route():
  widths = _config_widths()
  assert (512, 3072) in widths and (768, 3072) in widths
  for h, i in widths:
    for mp in (1, 2, 4):        # I/mp of a tensor-parallel rank
      assert ffn.gemm_route(h, i // mp, torch.bfloat16), (h, i, mp)
      for rows in (CHUNK * VIDEO_TOKENS, CHUNK * TEXT_TOKENS, 1013, 1):
        tile = ffn.pick_gemm_tile(rows, h, H100_SMS)
        assert 0 <= tile < len(ffn.GEMM_TILES)


@pytest.mark.parametrize("h,i,dtype", [
    (64, 256, torch.bfloat16),      # H off the 128-column tile
    (512, 3136, torch.bfloat16),    # I a multiple of 64, not of 128
    (48, 128, torch.bfloat16),
    (1152, 3072, torch.bfloat16),   # wider than the LayerNorm pass takes
    (512, 3072, torch.float32)])    # fp32 keeps the FMA kernel
def test_other_widths_keep_the_wmma_route(h, i, dtype):
  assert not ffn.gemm_route(h, i, dtype)


def test_tile_choice_at_the_flagship_shapes():
  video, text = CHUNK * VIDEO_TOKENS, CHUNK * TEXT_TOKENS
  assert (video, text) == (10900, 1500)
  # Video: 86 x 4 = 344 tiles of 128 rows in the second GEMM.
  assert ffn.pick_gemm_tile(video, 512, H100_SMS) == 0
  # Text: 12 x 6 = 72 tiles of 128 rows, fewer than the SMs: 64 rows.
  assert ffn.pick_gemm_tile(text, 768, H100_SMS) == 1
  assert ffn.pick_gemm_tile(1013, 768, H100_SMS) == 1
  assert ffn.pick_gemm_tile(text, 768, 64) == 0


def test_python_tiles_match_the_c_tiles():
  src = (_build.CSRC / "ffn_gemm.cuh").read_text()
  rows = re.search(r"kTileRows\[\] = \{([^}]*)\}", src).group(1)
  assert tuple(int(v) for v in rows.split(",")) == ffn.GEMM_TILES
  n = re.search(r"kNumTiles = (\d+);", src).group(1)
  assert int(n) == len(ffn.GEMM_TILES)


def test_python_route_limits_match_the_c_launcher():
  """gemm_route is the one decider; the C launcher only refuses what it
  does not take, by the same constants."""
  gemm = (_build.CSRC / "ffn_gemm.cuh").read_text()
  common = (_build.CSRC / "ffn_common.cuh").read_text()
  assert int(re.search(r"constexpr int BN = (\d+);", gemm).group(1)) == \
      ffn.GEMM_COLS
  assert int(re.search(r"constexpr int MAX_H = (\d+);", common).group(1)) \
      == ffn.MAX_H
  block = (_build.CSRC / "ffn_block.cu").read_text()
  assert not re.search(r"\bgemm_route\(", re.sub(r"//.*", "", block))


@pytest.mark.parametrize("h,i,dtype,tile,want", [
    (128, 256, torch.bfloat16, 1, 1),     # on the route: the tile asked for
    (128, 256, torch.bfloat16, 0, 0),
    (192, 768, torch.bfloat16, 0, -1),    # off it: -1 (WMMA), whatever tile
    # fp32 takes its own route here, the 32-row tile picked for 40 rows
    # (the case keeps the name it had when fp32 ran the FMA kernel).
    pytest.param(128, 256, torch.float32, None, 2,
                 id="128-256-dtype3-None--1"),
    (192, 768, torch.float32, None, -1),  # fp32 off its route: -1 (FMA)
    (128, 256, torch.float32, -1, -1),    # the FMA kernel at a route shape
    (128, 256, torch.float32, 0, 0)])     # the fp32 tile asked for
def test_wrappers_pass_c_the_route_as_the_tile_id(h, i, dtype, tile, want,
                                                  monkeypatch):
  monkeypatch.setitem(ffn._SMS, None, H100_SMS)
  cpu = torch.device("cpu")
  buf, xb, g, got = ffn._gemm_scratch(40, h, i, dtype, tile, cpu)
  assert got == want
  if want < 0:
    assert (buf, xb, g) == (None, None, None)
  elif dtype == torch.float32:   # g alone, fp32: x needs no cast
    assert buf.dtype == torch.float32 and buf.numel() == 40 * i
    assert (xb, g) == (None, buf.data_ptr())
  else:
    assert buf.dtype == torch.bfloat16 and buf.numel() == 40 * (h + i)
    assert (xb, g) == (buf.data_ptr(), buf.data_ptr() + 2 * 40 * h)


class FakeCuda:
  """A CPU tensor that passes for one on the card, with a chosen
  address offset and contiguity: what the wrappers check before any
  launch."""

  def __init__(self, t, offset=0, contiguous=True):
    self.t, self.offset, self.contiguous = t, offset, contiguous
    self.shape, self.dtype = t.shape, t.dtype
    self.device, self.is_cuda = torch.device("cuda", 0), True

  def dim(self):
    return self.t.dim()

  def is_contiguous(self):
    return self.contiguous

  def data_ptr(self):
    return (self.t.data_ptr() // 256) * 256 + 256 + self.offset


def _operands(r=40, h=128, i=256, partial=False):
  bf = torch.bfloat16
  ops = dict(x=torch.randn(r, h), w1=torch.randn(i, h).to(bf),
             b1=torch.randn(i), w2=torch.randn(h, i).to(bf))
  if not partial:
    ops.update(b2=torch.randn(h), gamma=torch.randn(h), beta=torch.randn(h))
  return ops


def _call(partial, ops):
  if partial:
    return ffn.ffn_partial_cuda(*ops.values(), compute_dtype=torch.bfloat16)
  return ffn.ffn_block_cuda(*ops.values(), eps=1e-12,
                            compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("misaligned x", "16-byte aligned"),
    ("misaligned b1", "16-byte aligned"),
    ("rows not contiguous", "contiguous")])
def test_wrappers_refuse_what_tma_cannot_take(partial, case, match):
  kernel = ffn.ffn_partial_cuda if partial else ffn.ffn_block_cuda
  before = kernel.launches
  ops = _operands(partial=partial)
  if case != "cpu":
    ops = {n: FakeCuda(t) for n, t in ops.items()}
    if case == "misaligned x":
      ops["x"] = FakeCuda(ops["x"].t, offset=8)
    elif case == "misaligned b1":
      ops["b1"] = FakeCuda(ops["b1"].t, offset=4)
    else:
      ops["x"] = FakeCuda(ops["x"].t, contiguous=False)
  with pytest.raises(ValueError, match=match):
    _call(partial, ops)
  assert kernel.launches == before


def _entry_points():
  """{name: number of parameters} of every extern "C" function in csrc/."""
  found = {}
  for path in sorted(_build.CSRC.glob("*.cu")):
    for m in re.finditer(r'extern "C" [\w\s\*]+?(\w+)\(([^)]*)\)',
                         path.read_text()):
      found[m.group(1)] = len([p for p in m.group(2).split(",") if p.strip()])
  return found


def test_build_names_every_entry_point_with_its_arity():
  assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
  assert set(_build.HEADERS) == {p.name for p in _build.CSRC.glob("*.cuh")}
  found = _entry_points()
  assert "mmt_ffn_block" in found and "mmt_ffn_partial" in found
  # The train entry points take the route's scratch and tile id too.
  assert found["mmt_ffn_train_fwd"] == 20
  assert found["mmt_ffn_train_bwd"] == 21
  assert found["mmt_ffn_train_fwd_partial"] == 14
  assert found.pop("mmt_error_string") == 1
  assert set(found) == set(_build._SIGNATURES)
  for name, n in found.items():
    assert len(_build._SIGNATURES[name]) == n, name
