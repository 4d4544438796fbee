"""Host side of the fp32 route of the FFN kernels (B1, B2, B3, B6, B7).

The route (csrc/ffn_sgemm.cuh's SIMT GEMM, with the row passes and
epilogues of csrc/ffn_block.cu and csrc/ffn_train_bwd.cu) runs only on
the card.  Which calls take it, the tile id and the fp32 scratch the
wrappers hand the C entry points, and what they refuse before any launch
are plain Python and source text, checked here with operands that pass
for CUDA tensors and a recording stand-in for the launch; the plain
versions the route is held to on the card are held here to the JAX
package at the route's widths, fp32, its Pallas kernels in interpret
mode.
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu_torch import _build
from mmt_tpu_torch.config import TEXT_BERT_BASE_CASED
from mmt_tpu_torch.ops import ffn
from tests.test_torch_ffn_route import H100_SMS, FakeCuda
from tests.test_torch_ffn_train_route import OnCpu

REPO = pathlib.Path(__file__).resolve().parents[1]
F32, BF = torch.float32, torch.bfloat16
VIDEO_TOKENS, TEXT_TOKENS = 1 + 7 * (1 + 30), 30   # the flagship's


def _config_widths():
  """(H, I / mp) of every FFN of configs/eccv20/ (each config's video
  tower and the bert-base-cased text tower) for mp = 1, 2 and 4."""
  widths = {(TEXT_BERT_BASE_CASED.hidden_size,
             TEXT_BERT_BASE_CASED.intermediate_size)}
  paths = sorted((REPO / "configs" / "eccv20").glob("*.json"))
  assert len(paths) == 7
  for path in paths:
    args = json.loads(path.read_text())["arch"]["args"]
    # fp32 is CENet's default: no shipped config sets another.
    assert "compute_dtype" not in args, path.name
    vid = args["vid_bert_params"]
    widths.add((vid["hidden_size"], vid["intermediate_size"]))
  return sorted((h, i // mp) for h, i in widths for mp in (1, 2, 4))


@pytest.mark.parametrize("h,i", _config_widths())
def test_every_config_width_takes_the_f32_route(h, i):
  assert ffn.f32_route(h, i, F32)
  # gemm_route keeps its meaning: the bf16 TMA + wgmma route only.
  assert not ffn.gemm_route(h, i, F32) and ffn.gemm_route(h, i, BF)


@pytest.mark.parametrize("h,i", _config_widths())
def test_the_fma_kernel_stays_off_every_config_width(h, i, monkeypatch):
  monkeypatch.setitem(ffn._SMS, None, H100_SMS)
  cpu = torch.device("cpu")
  for rows in (50 * VIDEO_TOKENS, 50 * TEXT_TOKENS, 32 * VIDEO_TOKENS,
               32 * TEXT_TOKENS, 1013, 1):
    tile = ffn._route_tile(rows, h, i, F32, None, cpu)
    assert 0 <= tile < len(ffn.F32_TILES), (rows, tile)
    # Only a check asks for the FMA kernel at a route width.
    assert ffn._route_tile(rows, h, i, F32, -1, cpu) == -1


@pytest.mark.parametrize("h,i,dtype", [
    (64, 256, F32),       # H off the 128-column tile
    (192, 768, F32),
    (512, 3136, F32),     # I a multiple of 64, not of 128
    (1152, 3072, F32),    # wider than the LayerNorm pass takes
    (512, 3072, BF)])     # bf16 has the GEMM route
def test_other_widths_and_types_are_off_the_f32_route(h, i, dtype,
                                                      monkeypatch):
  monkeypatch.setitem(ffn._SMS, None, H100_SMS)
  assert not ffn.f32_route(h, i, dtype)
  if dtype == F32:
    assert ffn._route_tile(40, h, i, dtype, None, torch.device("cpu")) == -1


@pytest.mark.parametrize("rows,h,tile_rows", [
    (50 * VIDEO_TOKENS, 512, 128),   # eval video 10,900
    (50 * TEXT_TOKENS, 768, 128),    # eval text 1,500
    (32 * VIDEO_TOKENS, 512, 128),   # b32 video 6,976
    (32 * TEXT_TOKENS, 768, 64),     # b32 text 960: GEMM 2 48 / 90 blocks
    (1013, 768, 64),                 # ragged
    (128 * VIDEO_TOKENS, 512, 128),  # b128 video 27,904
    (128 * TEXT_TOKENS, 768, 64),    # b128 text 3,840: GEMM 2 180 / 360
    (64 * TEXT_TOKENS, 768, 128),    # 64 queries' text, 1,920
    (8 * VIDEO_TOKENS, 512, 64),     # the last eval batch of 8, 1,744
    (4 * VIDEO_TOKENS, 512, 64),     # a DP rank's half of it, 872: GEMM 1
                                     # in 32-row tiles, 672 blocks
    (16 * TEXT_TOKENS, 768, 32),     # 480
    (8 * TEXT_TOKENS, 768, 32),      # 240
    (30, 768, 32)])                  # a query's text rows
def test_f32_tile_choice_at_the_flagship_shapes(rows, h, tile_rows):
  tile = ffn.pick_f32_tile(rows, h, 3072, H100_SMS)
  assert ffn.F32_TILES[tile] == tile_rows


def test_f32_tile_rates_are_one_a_tile_the_largest_first(monkeypatch):
  assert len(ffn.F32_TILE_RATES) == len(ffn.F32_TILES)
  assert ffn.F32_TILE_RATES[0] == 1.0
  assert list(ffn.F32_TILE_RATES) == sorted(ffn.F32_TILE_RATES, reverse=True)
  # A tie goes to the larger tile: one block of each a busiest SM in
  # both GEMMs, at rates that give them one cost.
  monkeypatch.setattr(ffn, "F32_TILE_RATES", (1.0, 0.5, 0.25))
  assert ffn.pick_f32_tile(32, 128, 128, H100_SMS) == 0


def test_python_tiles_match_the_c_tiles():
  src = (_build.CSRC / "ffn_sgemm.cuh").read_text()
  rows = re.search(r"kTileRows\[\] = \{([^}]*)\}", src).group(1)
  assert tuple(int(v) for v in rows.split(",")) == ffn.F32_TILES
  assert int(re.search(r"kNumTiles = (\d+);", src).group(1)) == len(
      ffn.F32_TILES)
  assert int(re.search(r"constexpr int BN = (\d+);", src).group(1)) == \
      ffn.F32_COLS
  assert "ffn_sgemm.cuh" in _build.HEADERS


def _code(name):
  """The C++ source of csrc/``name`` without its comments."""
  return re.sub(r"//.*", "", (_build.CSRC / name).read_text())


def _body(src, fn):
  """The text of the C++ function ``fn`` in ``src``, to its closing
  brace at column 0."""
  start = re.search(rf'^(?:extern "C" )?\w[\w<>, ]* {fn}\(', src,
                    re.M).start()
  return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("source,launcher,gemms", [
    ("ffn_block.cu", "launch_f32_route", 5),   # GEMM 1 of 2 modes, 2 of 3
    ("ffn_train_bwd.cu", "launch_bwd_f32_route", 3)])
def test_c_launchers_refuse_a_shape_but_never_pick_the_route(source,
                                                             launcher,
                                                             gemms):
  """f32_route and pick_f32_tile are the one decider: the C launchers
  only refuse what the route does not take, by the header's constants,
  and take the tile id they are given."""
  src = _code(source)
  assert not re.search(r"\bf32_route\(|\bpick_f32_tile\(", src)
  body = _body(src, launcher)
  for refusal in ("compute_dtype != 0", "H % mmt_sgemm::BN",
                  "I % mmt_sgemm::BN", "H > MAX_H",
                  "tile >= mmt_sgemm::kNumTiles", "!aligned16(p)"):
    assert refusal in body, refusal
  # Each GEMM of the route gets the caller's tile id, none its own.
  calls = re.findall(r"mmt_sgemm::sgemm<(true|false)>\(([^;]*)\);", body,
                     re.S)
  assert len(calls) == gemms
  assert all(re.search(r",\s*tile,", args) for _, args in calls)
  # The forward reads the weights as stored with K contiguous, the
  # backward as stored with N contiguous: no transposed copy.
  layout = "true" if launcher == "launch_f32_route" else "false"
  assert {b for b, _ in calls} == {layout}
  assert "w1t" not in body and "transpose" not in body


def test_entry_points_send_fp32_tiles_to_the_f32_route():
  block, bwd = _code("ffn_block.cu"), _code("ffn_train_bwd.cu")
  routes = _body(block, "launch_routes")
  assert re.search(r"if \(compute_dtype == 0\) \{\s*return "
                   r"launch_f32_route<kMode>", routes)
  for name in ("mmt_ffn_block", "mmt_ffn_train_fwd", "mmt_ffn_partial",
               "mmt_ffn_train_fwd_partial"):
    assert "launch_routes<Mode::" in _body(block, name), name
  assert re.search(r"if \(tile >= 0 && compute_dtype == 0\) \{\s*return "
                   r"launch_bwd_f32_route\(", _body(bwd, "mmt_ffn_train_bwd"))


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


def _operands(which, r, h, i, wrap=OnCpu):
  g = torch.Generator().manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=g)
  w1, w2 = rand(i, h), rand(h, i)
  if which in ("block", "train_fwd"):
    ops = dict(x=rand(r, h), drop=rand(r, h), w1=w1, b1=rand(i), w2=w2,
               b2=rand(h), gamma=rand(h), beta=rand(h))
    if which == "block":
      del ops["drop"]
  elif which == "train_bwd":
    ops = dict(dy=rand(r, h), z=rand(r, h), inter=rand(r, i),
               drop=rand(r, h), w1=w1, w2=w2, gamma=rand(h))
  else:
    ops = dict(x=rand(r, h), w1=w1, b1=rand(i), w2=w2)
  return {n: wrap(t) for n, t in ops.items()}


_WRAPPERS = {"block": ffn.ffn_block_cuda, "train_fwd": ffn.ffn_train_fwd_cuda,
             "train_bwd": ffn.ffn_train_bwd_cuda,
             "partial": ffn.ffn_partial_cuda,
             "train_fwd_partial": ffn.ffn_train_fwd_partial_cuda}
# The index of the tile id and of the scratch addresses in each entry
# point's arguments (csrc/: the stream is added by _launch).
_SCRATCH = {"block": (8, 9), "train_fwd": (11, 12),
            "train_bwd": (10, 11, 12), "partial": (5, 6),
            "train_fwd_partial": (6, 7)}


def _call(which, ops, **kw):
  fn = _WRAPPERS[which]
  if which in ("block", "train_fwd", "train_bwd"):
    kw["eps"] = 1e-12
  return fn(*ops.values(), compute_dtype=F32, **kw)


@pytest.mark.parametrize("which", sorted(_WRAPPERS))
@pytest.mark.parametrize("h,i,tile,want", [
    (128, 256, None, 2),      # the route, picked: 40 rows, the 32-row tile
    (128, 256, 0, 0),         # the route, the tile asked for
    (128, 256, -1, -1),       # the FMA kernel at a route width
    (192, 768, None, -1),     # off the route: the FMA kernel
    (192, 768, 1, -1)])       # off it whatever tile is asked for
def test_fp32_wrappers_pass_c_the_tile_and_fp32_scratch(which, h, i, tile,
                                                        want, launches):
  r = 40
  before = _WRAPPERS[which].launches
  _call(which, _operands(which, r, h, i), tile=tile)
  assert _WRAPPERS[which].launches == before + 1
  (name, args), = launches
  assert name == f"mmt_ffn_{which}"
  assert args[-1] == want
  scratch = [args[k] for k in _SCRATCH[which]]
  if want < 0:
    assert scratch == [None] * len(scratch)
  elif which == "train_bwd":   # dffn [R, H]; no transposed weights
    assert scratch[0] is not None and scratch[1:] == [None, None]
  else:                        # g [R, I]; no cast of x (xb)
    assert scratch[0] is None and scratch[1] is not None


@pytest.mark.parametrize("which", sorted(_WRAPPERS))
def test_fp32_route_refuses_misaligned_operands(which, launches):
  """The route's 16-byte loads need aligned operands: a misaligned one
  raises before any launch at a route width, and the FMA kernel takes
  it at a width off the route."""
  before = _WRAPPERS[which].launches
  ops = _operands(which, 40, 128, 256, wrap=FakeCuda)
  first = next(iter(ops))
  ops[first] = FakeCuda(ops[first].t, offset=8)
  with pytest.raises(ValueError, match="16-byte aligned"):
    _call(which, ops)
  assert _WRAPPERS[which].launches == before and not launches
  ops = _operands(which, 40, 192, 768)
  ops[first] = OnCpu(ops[first].t, offset=8)
  _call(which, ops)
  (_, args), = launches
  assert args[-1] == -1


# The plain versions at a route width, fp32, against the JAX package's
# Pallas kernels in interpret mode: the rules of tests/test_torch_ffn.py
# and tests/test_torch_ffn_train.py (fp32 sum-order noise, 2e-5; B3 2e-4
# relative for the JAX backward's A&S erf).
R, H, I = 40, 128, 256


def _inputs(seed, p=0.25):
  rng = np.random.RandomState(seed)
  x = rng.randn(R, H).astype(np.float32)
  w1 = (rng.randn(H, I) * 0.05).astype(np.float32)
  b1 = (rng.randn(I) * 0.05).astype(np.float32)
  w2 = (rng.randn(I, H) * 0.05).astype(np.float32)
  b2 = (rng.randn(H) * 0.05).astype(np.float32)
  gamma = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
  beta = (0.1 * rng.randn(H)).astype(np.float32)
  drop = ((rng.rand(R, H) >= p).astype(np.float32) / (1.0 - p))
  return (x, w1, b1, w2, b2, gamma, beta), drop


def _t(a):
  return torch.from_numpy(np.array(a))


def test_eval_block_at_a_route_width_matches_pallas():
  assert ffn.f32_route(H, I, F32)
  (x, w1, b1, w2, b2, gamma, beta), _ = _inputs(1)
  want = jax_ffn.ffn_block(x, w1, b1, w2, b2, gamma, beta, eps=1e-12,
                           compute_dtype=jnp.float32, interpret=True)
  got = ffn.ffn_block(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), _t(gamma),
                      _t(beta), eps=1e-12, compute_dtype=F32)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                             atol=2e-5)


def test_train_forward_at_a_route_width_matches_pallas():
  (x, w1, b1, w2, b2, gamma, beta), drop = _inputs(2)
  want = jax_ffn._pallas_ffn_train_fwd(
      x, drop, w1, b1, w2, b2, gamma, beta, eps=1e-12,
      compute_dtype=jnp.float32, interpret=True)
  got = ffn.ffn_train_fwd_plain(_t(x), _t(drop), _t(w1.T), _t(b1), _t(w2.T),
                                _t(b2), _t(gamma), _t(beta), eps=1e-12,
                                compute_dtype=F32)
  for name, g, w in zip(("out", "inter", "z"), got, want):
    assert g.dtype == F32, name
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                               atol=2e-5, err_msg=name)


@pytest.mark.parametrize("add_dz", [True, False])
def test_train_backward_at_a_route_width_matches_pallas(add_dz):
  (x, w1, b1, w2, b2, gamma, beta), drop = _inputs(3)
  _, inter, z = jax_ffn._pallas_ffn_train_fwd(
      x, drop, w1, b1, w2, b2, gamma, beta, eps=1e-12,
      compute_dtype=jnp.float32, interpret=True)
  inter, z = np.asarray(inter), np.asarray(z)
  dy = np.random.RandomState(4).randn(R, H).astype(np.float32)
  want = jax_ffn._pallas_ffn_train_bwd(
      dy, z, inter, drop, w1, w2, gamma, eps=1e-12,
      compute_dtype=jnp.float32, interpret=True, add_dz=add_dz)
  got = ffn.ffn_train_bwd_plain(_t(dy), _t(z), _t(inter), _t(drop),
                                _t(w1.T), _t(w2.T), _t(gamma), eps=1e-12,
                                compute_dtype=F32, add_dz=add_dz)
  for name, g, w in zip(("dx", "dz", "dinter"), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                               atol=1e-5, err_msg=name)
