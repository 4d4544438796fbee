"""Routed SwiGLU experts of a mixture-of-experts layer, over the experts
this card holds (models/moe_text.py).

``grouped_experts(x, weights, sel, w_gate_up, w_down, slot_of)`` returns
sum_j weights[t, j] E_{sel[t, j]}(x[t]) for each token t, over the choices
whose expert is held here (``slot_of[e]`` its slot, or the number of held
experts for an expert held elsewhere); E_e(x) = W_down,e (silu(W_gate,e x)
* W_up,e x).  The gate and up weights are one [E, 2I, H] tensor, gate row
n at 2n and up row n at 2n + 1; the down weights are [E, H, I].

The assignments are sorted by held slot on the device (``route_plan``:
comparisons and prefix sums, no ``nonzero``, ``bincount``, boolean index
or host read), so that a train step holding the layer stays one CUDA
graph (train/step.py).  On the card the products are the grouped fp32
GEMMs of csrc/moe_grouped.cu, whose grids are sized for all T x K
assignments and which read the experts' row ranges from the device; a
CPU tensor takes their plain versions, a loop over the experts.  The
forward and backward (``GroupedExperts``) are the same code on both, with
one set of the six entry points or the other.  Every launch on the card
counts in ``moe_grouped_cuda.launches`` (8 a layer and train step: 3
forward, 5 backward).  The kernels' family is ``"moe"``
(``ops.plain_versions("moe")`` sends the card to the loop).
"""

from __future__ import annotations

import torch

from mmt_tpu_torch import _build, ops


def route_plan(sel, slot_of, held):
  """The sorted rows of the assignments ``sel`` [T, K] (expert ids) for
  ``held`` experts with slots ``slot_of`` [n_experts]: (tok [T K] int32,
  the token of each row; pos [T, K] int32, the row of each assignment;
  offsets [held + 1] int32, expert e's rows being offsets[e] ..
  offsets[e + 1]).  Rows are in slot order, the assignments of experts
  held elsewhere last (from offsets[held] on), and in assignment order
  within a slot."""
  t, k = sel.shape
  key = slot_of[sel].reshape(-1)
  buckets = torch.arange(held + 1, device=sel.device)
  # [E + 1, R]: the prefix sums run along the last dim (a scan along the
  # first takes milliseconds on the card at 19,200 x 9).
  onehot = (buckets[:, None] == key[None]).to(torch.int32)
  counts = onehot.sum(1, dtype=torch.int32)
  ends = torch.cumsum(counts, 0, dtype=torch.int32)
  rank = (torch.cumsum(onehot, 1, dtype=torch.int32) * onehot).sum(
      0, dtype=torch.int32) - 1
  pos = (ends - counts)[key] + rank
  tok = torch.empty_like(pos).scatter_(
      0, pos.long(), torch.arange(t * k, device=sel.device,
                                  dtype=torch.int32) // k)
  offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=sel.device),
                       ends[:held]])
  return tok, pos.view(t, k), offsets


# ---------------------------------------------------------------------------
# Plain versions: a loop over the held experts (the offsets read on the
# host).  Rows past the held experts' are zeros.
# ---------------------------------------------------------------------------


def _ranges(offsets):
  o = offsets.tolist()
  return [(e, o[e], o[e + 1]) for e in range(len(o) - 1)]


def _silu_parts(gu):
  gate, up = gu[:, 0::2], gu[:, 1::2]
  sg = torch.sigmoid(gate)
  return gate, up, sg, gate * sg


def gate_up_plain(x, tok, offsets, w_gu):
  """gu [R, 2I] = x[tok] W_gu,e^T over each expert's rows; a = silu(gate)
  * up [R, I]."""
  gu = x.new_zeros(tok.numel(), w_gu.shape[1])
  for e, lo, hi in _ranges(offsets):
    gu[lo:hi] = x[tok[lo:hi].long()] @ w_gu[e].T
  _, up, _, act = _silu_parts(gu)
  return gu, act * up


def down_plain(a, offsets, w_d, rw):
  """ys [R, H] = rw[r] (a[r] W_d,e^T)."""
  ys = a.new_zeros(a.shape[0], w_d.shape[1])
  for e, lo, hi in _ranges(offsets):
    ys[lo:hi] = rw[lo:hi, None] * (a[lo:hi] @ w_d[e].T)
  return ys


def combine_plain(ys, pos, offsets, tokens):
  """out [T, H]: the held rows of each token's choices, added in choice
  order."""
  out = ys.new_zeros(tokens, ys.shape[1])
  held = int(offsets[-1])
  for j in range(pos.shape[1]):
    p = pos[:, j].long()
    out += torch.where((p < held)[:, None], ys[p], torch.zeros_like(out))
  return out


def dgate_up_plain(dout, tok, offsets, w_d, gu, rw):
  """(dgu [R, 2I], a [R, I], g [R, I]): g = dout[tok] W_d,e, and the
  SwiGLU's gradient at rw g."""
  g = dout.new_zeros(tok.numel(), w_d.shape[2])
  for e, lo, hi in _ranges(offsets):
    g[lo:hi] = dout[tok[lo:hi].long()] @ w_d[e]
  gate, up, sg, act = _silu_parts(gu)
  da = rw[:, None] * g
  dgu = torch.stack([da * up * (sg * (1.0 + gate * (1.0 - sg))), da * act],
                    -1).reshape(gu.shape)
  return dgu, act * up, g


def dx_plain(dgu, offsets, w_gu):
  """dxs [R, H] = dgu[r] W_gu,e."""
  dxs = dgu.new_zeros(dgu.shape[0], w_gu.shape[2])
  for e, lo, hi in _ranges(offsets):
    dxs[lo:hi] = dgu[lo:hi] @ w_gu[e]
  return dxs


def wgrad_plain(a, a_idx, a_scale, b, b_idx, offsets):
  """C [E, M, N], C_e = sum over expert e's rows r of s[r] A[ia(r)]^T
  B[ib(r)] (ia, ib: the index, or r; s: the scale, or 1)."""
  ranges = _ranges(offsets)
  c = a.new_zeros(len(ranges), a.shape[1], b.shape[1])
  for e, lo, hi in ranges:
    av = a[a_idx[lo:hi].long()] if a_idx is not None else a[lo:hi]
    if a_scale is not None:
      av = av * a_scale[lo:hi, None]
    bv = b[b_idx[lo:hi].long()] if b_idx is not None else b[lo:hi]
    c[e] = av.T @ bv
  return c


PLAIN = dict(gate_up=gate_up_plain, down=down_plain, combine=combine_plain,
             dgate_up=dgate_up_plain, dx=dx_plain, wgrad=wgrad_plain)


# ---------------------------------------------------------------------------
# The kernels (csrc/moe_grouped.cu).
# ---------------------------------------------------------------------------


def _operands(kernel, floats, ints):
  """Raise unless every operand lies on one CUDA device, contiguous, the
  floats fp32 and 16-byte aligned, the indices int32; the device."""
  named = [t for t in (*floats, *ints) if t is not None]
  dev = named[0].device
  if not all(t.is_cuda and t.device == dev and t.is_contiguous()
             for t in named):
    raise ValueError(f"{kernel} kernel: operands must be contiguous and lie "
                     "on one CUDA device")
  if not all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
             for t in floats if t is not None):
    raise ValueError(f"{kernel} kernel: float operands must be fp32 and "
                     "16-byte aligned")
  if not all(t.dtype == torch.int32 for t in ints if t is not None):
    raise ValueError(f"{kernel} kernel: indices must be int32")
  return dev


def _widths(kernel, h, i):
  if h % 128 or i % 128:
    raise ValueError(f"{kernel} kernel: H and I must be multiples of 128 "
                     f"(H={h}, I={i})")


def _ptr(t):
  return None if t is None else t.data_ptr()


def moe_grouped_cuda(name, dev, *args):
  """Launch the C entry point ``name`` on ``dev``'s current stream;
  raises on a CUDA error.  Counts every launch."""
  lib = _build.load_library()
  with torch.cuda.device(dev):
    code = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
  _build.check(lib, name, code)
  moe_grouped_cuda.launches += 1


moe_grouped_cuda.launches = 0


def gate_up_cuda(x, tok, offsets, w_gu):
  e, two_i, h = w_gu.shape
  _widths("moe gate_up", h, two_i // 2)
  dev = _operands("moe gate_up", (x, w_gu), (tok, offsets))
  gu = torch.empty((tok.numel(), two_i), device=dev)
  a = torch.empty((tok.numel(), two_i // 2), device=dev)
  moe_grouped_cuda("mmt_moe_gate_up", dev, x.data_ptr(), tok.data_ptr(),
                   offsets.data_ptr(), w_gu.data_ptr(), gu.data_ptr(),
                   a.data_ptr(), tok.numel(), e, h, two_i // 2)
  return gu, a


def down_cuda(a, offsets, w_d, rw):
  e, h, i = w_d.shape
  _widths("moe down", h, i)
  dev = _operands("moe down", (a, w_d, rw), (offsets,))
  ys = torch.empty((a.shape[0], h), device=dev)
  moe_grouped_cuda("mmt_moe_down", dev, a.data_ptr(), offsets.data_ptr(),
                   w_d.data_ptr(), rw.data_ptr(), ys.data_ptr(), a.shape[0],
                   e, h, i)
  return ys


def combine_cuda(ys, pos, offsets, tokens):
  dev = _operands("moe combine", (ys,), (pos, offsets))
  out = torch.empty((tokens, ys.shape[1]), device=dev)
  moe_grouped_cuda("mmt_moe_combine", dev, ys.data_ptr(), pos.data_ptr(),
                   offsets.data_ptr(), offsets.numel() - 1, tokens,
                   pos.shape[1], ys.shape[1], out.data_ptr())
  return out


def dgate_up_cuda(dout, tok, offsets, w_d, gu, rw):
  e, h, i = w_d.shape
  _widths("moe dgate_up", h, i)
  dev = _operands("moe dgate_up", (dout, w_d, gu, rw), (tok, offsets))
  r = tok.numel()
  dgu = torch.empty((r, 2 * i), device=dev)
  a = torch.empty((r, i), device=dev)
  g = torch.empty((r, i), device=dev)
  moe_grouped_cuda("mmt_moe_dgate_up", dev, dout.data_ptr(), tok.data_ptr(),
                   offsets.data_ptr(), w_d.data_ptr(), gu.data_ptr(),
                   rw.data_ptr(), dgu.data_ptr(), a.data_ptr(), g.data_ptr(),
                   r, e, h, i)
  return dgu, a, g


def dx_cuda(dgu, offsets, w_gu):
  e, two_i, h = w_gu.shape
  _widths("moe dx", h, two_i // 2)
  dev = _operands("moe dx", (dgu, w_gu), (offsets,))
  dxs = torch.empty((dgu.shape[0], h), device=dev)
  moe_grouped_cuda("mmt_moe_dx", dev, dgu.data_ptr(), offsets.data_ptr(),
                   w_gu.data_ptr(), dxs.data_ptr(), dgu.shape[0], e, h,
                   two_i // 2)
  return dxs


def wgrad_cuda(a, a_idx, a_scale, b, b_idx, offsets):
  m, n = a.shape[1], b.shape[1]
  _widths("moe wgrad", m, n)
  dev = _operands("moe wgrad", (a, a_scale, b), (a_idx, b_idx, offsets))
  e = offsets.numel() - 1
  c = torch.empty((e, m, n), device=dev)
  moe_grouped_cuda("mmt_moe_wgrad", dev, a.data_ptr(), _ptr(a_idx),
                   _ptr(a_scale), m, b.data_ptr(), _ptr(b_idx), n,
                   offsets.data_ptr(), e, c.data_ptr())
  return c


KERNELS = dict(gate_up=gate_up_cuda, down=down_cuda, combine=combine_cuda,
               dgate_up=dgate_up_cuda, dx=dx_cuda, wgrad=wgrad_cuda)


class GroupedExperts(torch.autograd.Function):
  """The held experts' part of a routed layer: x [T, H], weights [T, K]
  (the routing weights, differentiable), sel [T, K] expert ids, w_gate_up
  [E, 2I, H], w_down [E, H, I], slot_of [n_experts] -> [T, H].  The
  kernels or the plain versions are chosen once, in the forward."""

  @staticmethod
  def forward(ctx, x, weights, sel, w_gate_up, w_down, slot_of):
    ops_ = KERNELS if ops.use_kernel(x, "moe") else PLAIN
    tokens, k = sel.shape
    tok, pos, offsets = route_plan(sel, slot_of, w_gate_up.shape[0])
    rw = torch.empty(tokens * k, device=x.device).scatter_(
        0, pos.reshape(-1).long(), weights.reshape(-1).float())
    x = x.contiguous()
    gu, a = ops_["gate_up"](x, tok, offsets, w_gate_up)
    ys = ops_["down"](a, offsets, w_down, rw)
    out = ops_["combine"](ys, pos, offsets, tokens)
    ctx.save_for_backward(x, tok, pos, offsets, rw, gu, w_gate_up, w_down)
    ctx.ops = ops_
    return out

  @staticmethod
  def backward(ctx, dout):
    x, tok, pos, offsets, rw, gu, w_gate_up, w_down = ctx.saved_tensors
    ops_ = ctx.ops
    dout = dout.float().contiguous()
    dgu, a, g = ops_["dgate_up"](dout, tok, offsets, w_down, gu, rw)
    # A choice's weight gradient <dout[t], E(x[t])> = <g, a> of its row;
    # rows of experts held elsewhere give none (their buffers' rows past
    # the held ones hold no values: where, not a product, drops them).
    dweights = torch.where(pos < offsets[-1], (g * a).sum(1)[pos.long()],
                           torch.zeros((), device=dout.device))
    dx = ops_["combine"](ops_["dx"](dgu, offsets, w_gate_up), pos, offsets,
                         dout.shape[0])
    dw_gate_up = ops_["wgrad"](dgu, None, None, x, tok, offsets)
    dw_down = ops_["wgrad"](dout, tok, rw, a, None, offsets)
    return dx, dweights, None, dw_gate_up, dw_down, None


def grouped_experts(x, weights, sel, w_gate_up, w_down, slot_of):
  """The held experts' part of the layer's output (see the module)."""
  if x.dtype != torch.float32 or w_gate_up.dtype != torch.float32:
    raise ValueError("the routed experts run in fp32")
  return GroupedExperts.apply(x, weights, sel, w_gate_up, w_down, slot_of)
