"""Fused transformer FFN sub-block: LN(x + GELU_erf(x W1^T + b1) W2^T + b2).

Port of mmt_tpu/ops/ffn.py (``ffn_block``, ``ffn_block_train``,
``layer_norm`` and their tensor-parallel partition bodies).  On the card
each block is hand-written CUDA: the eval block (B1) and the train
forward (B2, with the pre-scaled dropout mask on ffn_out before the
residual) and their tensor-parallel partials (B6, B7) in
csrc/ffn_block.cu, the train backward (B3) in csrc/ffn_train_bwd.cu.  In
bf16 at the flagship's widths all five run as two TMA + wgmma GEMMs with
fused epilogues and row passes (csrc/ffn_gemm.cuh; ``gemm_route``,
``pick_gemm_tile``); otherwise one kernel keeps the [R, I] intermediate
out of device memory.
Under autograd the eval blocks' backward is the vjp of ``ffn_block_ref``,
the port of the JAX package's XLA reference, recomputed (as
mmt_tpu/ops/ffn.py:_fused_ffn_fn's).  The ``*_plain`` functions are the same
arithmetic in plain PyTorch.  All mirror the TPU kernels' numerics (not
the XLA references', which keep bias and GELU in the compute type):
operands rounded to the compute dtype, fp32 accumulation, fp32 bias and
exact erf-GELU, the GELU output rounded to the compute dtype, then fp32
residual + LayerNorm with the fast-variance form.  The train forward
also returns inter (pre-GELU) and z (pre-LN) rounded to the compute
dtype; the backward returns dz and dinter rounded to it.

Weights use nn.Linear's layout: w1 [I, H], w2 [H, I].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmt_tpu_torch import _build, ops
from mmt_tpu_torch.parallel import mesh as tp_lib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gelu_erf(x):
  """Exact (erf) GELU, as the reference's BERT uses."""
  return F.gelu(x, approximate="none")


def gelu_erf_grad(u):
  """d/du gelu_erf(u) = Phi(u) + u phi(u), with the exact erf."""
  phi = torch.exp(-0.5 * u * u) * 0.3989422804014327
  return 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) + u * phi


def _zhat(z, eps):
  """(z - mean) * rstd of fp32 rows, with the fast variance; and rstd."""
  mean = z.mean(-1, keepdim=True)
  var = ((z * z).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
  rstd = torch.rsqrt(var + eps)
  return (z - mean) * rstd, rstd


def layer_norm(y, gamma, beta, *, eps):
  """fp32 LayerNorm with flax's fast-variance form (mean(y^2) - mean^2,
  clamped at 0)."""
  return _zhat(y.float(), eps)[0] * gamma.float() + beta.float()


def ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, *, eps, compute_dtype):
  """Plain PyTorch version of the kernel: x [R, H] -> fp32 [R, H]."""
  cd = compute_dtype
  inter = x.to(cd).float() @ w1.to(cd).float().T + b1.float()
  inter = gelu_erf(inter).to(cd).float()
  y = inter @ w2.to(cd).float().T + b2.float() + x.float()
  return layer_norm(y, gamma, beta, eps=eps)


def ffn_block_ref(x, w1, b1, w2, b2, gamma, beta, *, eps, compute_dtype):
  """Port of mmt_tpu/ops/ffn.py:xla_ffn_block, the XLA reference whose vjp
  is the eval block's backward there: products, biases and GELU in the
  compute dtype, then the fp32 residual and LayerNorm."""
  cd = compute_dtype
  inter = gelu_erf(x.to(cd) @ w1.to(cd).T + b1.to(cd))
  y = (inter @ w2.to(cd).T + b2.to(cd)).float() + x.float()
  return layer_norm(y, gamma, beta, eps=eps)


# Row tiles of the GEMM route (csrc/ffn_gemm.cuh: kTileRows); a tile's id
# is its index here and in the C entry points.  Every tile issues the same
# wgmma chain over K for an output element, so all give the same bits.
GEMM_TILES = (128, 64)
GEMM_COLS = 128    # csrc/ffn_gemm.cuh: BN, the columns of a block tile
MAX_H = 1024       # csrc/ffn_common.cuh: MAX_H, the widest row the kernels take


def gemm_route(h, i, compute_dtype) -> bool:
  """True if the eval block (B1), the train forward (B2) and backward
  (B3) and the partials (B6, B7) take the TMA + wgmma GEMM route at
  widths H, I:
  bf16, H and I multiples of GEMM_COLS.  Else the WMMA kernel (bf16) or
  the FMA kernel (fp32).  The one place the route is chosen: the wrappers
  pass the C entry points a tile id on it and -1 off it."""
  return (compute_dtype == torch.bfloat16 and h % GEMM_COLS == 0
          and i % GEMM_COLS == 0 and h <= MAX_H)


def pick_gemm_tile(rows, h, sms) -> int:
  """Id of the GEMM route's row tile for ``rows`` rows of width ``h`` on
  a card with ``sms`` SMs, for every mode: 128 rows while the smaller of
  the two GEMMs' grids ([rows, H] in tiles of 128 columns) has a tile for
  every SM, else 64 rows (the text tower's 1,500 x 768 at eval: 72 tiles
  of 128 rows, 144 of 64; its 960 x 768 at the b32 step: 48 and 90)."""
  return 0 if -(-rows // GEMM_TILES[0]) * (h // 128) >= sms else 1


def _check_operands(kernel, *, f32, cd, rows, h, i, compute_dtype,
                    tma=False):
  """Raise ValueError unless the operands are what the kernel takes:
  ``f32`` / ``cd`` map names to (tensor, shape) in float32 / the compute
  dtype, ``cd`` including the weights w1 [I, H] and w2 [H, I]; with
  ``tma`` (the GEMM route) every operand 16-byte aligned.  Returns the
  operands' device."""
  def require(cond, msg):
    # msg formats lazily: a check that passes costs no formatting.
    if not cond:
      raise ValueError(f"{kernel} kernel: {msg()}")

  named = {**f32, **cd}
  dev = next(iter(named.values()))[0].device
  require(all(t.is_cuda and t.device == dev for t, _ in named.values()),
          lambda: "every operand must lie on the same CUDA device")
  require(compute_dtype in _DTYPE_CODES,
          lambda: f"compute dtype {compute_dtype} not supported")
  for name, (t, _) in f32.items():
    require(t.dtype == torch.float32,
            lambda: f"{name} must be float32, got {t.dtype}")
  for name, (t, _) in cd.items():
    require(t.dtype == compute_dtype,
            lambda: f"{name} must be {compute_dtype}, got {t.dtype}")
  for name, (t, shape) in named.items():
    require(t.shape == shape,
            lambda: f"{name} must have shape {shape}, got {tuple(t.shape)}")
  require(rows > 0 and h % 16 == 0 and 0 < h <= MAX_H and i % 16 == 0
          and i > 0, lambda: f"needs R > 0, H % 16 == 0, H <= {MAX_H} and I % "
          f"16 == 0 (R={rows}, H={h}, I={i})")
  require(all(t.is_contiguous() for t, _ in named.values()),
          lambda: "operands must be contiguous")
  require(all(cd[w][0].data_ptr() % 32 == 0 for w in ("w1", "w2")),
          lambda: "weights must be 32-byte aligned")
  require(not tma or all(t.data_ptr() % 16 == 0 for t, _ in named.values()),
          lambda: "operands must be 16-byte aligned (TMA and vector loads)")
  return dev


def _weight_shapes(x, w1):
  """(R, H, I) from rows x [R, H] and w1 [I, H]; raises on a non-2-D x."""
  if x.dim() != 2:
    raise ValueError(f"rows must be [R, H], got {tuple(x.shape)}")
  return x.shape[0], x.shape[1], w1.shape[0]


def _launch(lib, name, dev, *args):
  with torch.cuda.device(dev):
    code = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
  _build.check(lib, name, code)


_SMS = {}   # SM count by device index


def _route_tile(rows, h, i, compute_dtype, tile, dev):
  """The tile id a call passes C: -1 off the route, or when ``tile`` is -1
  (the WMMA / FMA kernel at any shape, for checks); else ``tile``, picked
  by ``pick_gemm_tile`` when None."""
  if tile == -1 or not gemm_route(h, i, compute_dtype):
    return -1
  if tile is None:
    if dev.index not in _SMS:
      _SMS[dev.index] = torch.cuda.get_device_properties(
          dev).multi_processor_count
    tile = pick_gemm_tile(rows, h, _SMS[dev.index])
  return tile


def _bf16_parts(dev, *sizes):
  """One bf16 allocation of parts of ``sizes`` values, and each part's
  address.  Every size on the route is a multiple of 128 values, so
  every part starts 256-byte aligned."""
  buf = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
  at = [buf.data_ptr()]
  for n in sizes[:-1]:
    at.append(at[-1] + 2 * n)
  return buf, at


def _gemm_scratch(rows, h, i, compute_dtype, tile, dev):
  """(scratch, the addresses of xb [R, H] and g [R, I] in it, tile id) of
  a GEMM-route call of B1, B6, B2 or B7.  Off the route (None, None, None,
  -1).  ``tile`` as for ``_route_tile``."""
  tile = _route_tile(rows, h, i, compute_dtype, tile, dev)
  if tile < 0:
    return None, None, None, -1
  buf, (xb, g) = _bf16_parts(dev, rows * h, rows * i)
  return buf, xb, g, tile


def _bwd_scratch(rows, h, i, compute_dtype, tile, dev):
  """(scratch, the addresses of dffn [R, H], w1t [H, I] and w2t [I, H] in
  it, tile id) of a GEMM-route call of B3: the LayerNorm backward's
  rounded dffn and the weights transposed for the TN GEMMs.  Off the
  route (None, None, None, None, -1)."""
  tile = _route_tile(rows, h, i, compute_dtype, tile, dev)
  if tile < 0:
    return None, None, None, None, -1
  buf, (dffn, w1t, w2t) = _bf16_parts(dev, rows * h, h * i, i * h)
  return buf, dffn, w1t, w2t, tile


def ffn_block_cuda(x, w1, b1, w2, b2, gamma, beta, *, eps, compute_dtype,
                   tile=None):
  """Launch csrc/ffn_block.cu on x [R, H] (CUDA); returns fp32 [R, H].
  ``tile`` (an id of ``GEMM_TILES``) overrides ``pick_gemm_tile`` on the
  GEMM route: for checks."""
  r, h, i = _weight_shapes(x, w1)
  dev = _check_operands(
      "ffn_block", rows=r, h=h, i=i, compute_dtype=compute_dtype,
      tma=gemm_route(h, i, compute_dtype),
      f32=dict(x=(x, (r, h)), b1=(b1, (i,)), b2=(b2, (h,)),
               gamma=(gamma, (h,)), beta=(beta, (h,))),
      cd=dict(w1=(w1, (i, h)), w2=(w2, (h, i))))
  out = torch.empty((r, h), dtype=torch.float32, device=dev)
  # scratch (xb and g) stays referenced until the launch is queued.
  scratch, xb, g, tile = _gemm_scratch(r, h, i, compute_dtype, tile, dev)
  _launch(_build.load_library(), "mmt_ffn_block", dev,
          x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
          b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
          xb, g, r, h, i, float(eps), _DTYPE_CODES[compute_dtype], tile)
  ffn_block_cuda.launches += 1
  return out


ffn_block_cuda.launches = 0


class _RefVjp(torch.autograd.Function):
  """A kernel's forward with, as its backward, the vjp of a reference
  recomputed from the saved inputs (mmt_tpu/ops/ffn.py:_fused_ffn_fn's
  ``bwd`` is jax.vjp of the XLA reference).  Takes the kernel, the
  reference, their keyword arguments, then the tensors."""

  @staticmethod
  def forward(ctx, kernel, ref, kw, *args):
    ctx.ref, ctx.kw = ref, kw
    ctx.save_for_backward(*args)
    return kernel(*args, **kw)

  @staticmethod
  def backward(ctx, dout):
    need = ctx.needs_input_grad[3:]
    with torch.enable_grad():
      args = [a.detach().requires_grad_(n)
              for a, n in zip(ctx.saved_tensors, need)]
      grads = iter(torch.autograd.grad(
          ctx.ref(*args, **ctx.kw), [a for a in args if a.requires_grad],
          dout))
    return (None, None, None, *(next(grads) if n else None for n in need))


def _eval_dispatch(x, kernel, plain, ref, args, kw):
  """The plain version for a CPU ``x``; else the kernel, and under
  autograd (an operand requiring grad) inside ``_RefVjp`` with ``ref``,
  so that the graph reaches the operands."""
  if not ops.use_kernel(x):
    return plain(*args, **kw)
  if torch.is_grad_enabled() and any(a.requires_grad for a in args):
    return _RefVjp.apply(kernel, ref, kw, *args)
  return kernel(*args, **kw)


def ffn_block(x, w1, b1, w2, b2, gamma, beta, *, eps,
              compute_dtype=torch.bfloat16):
  """Fused FFN sub-block over [..., H] input; returns fp32 [..., H].

  A CUDA tensor launches the kernel (which raises on what it does not
  take), differentiable through ``ffn_block_ref``'s vjp; a CPU tensor
  takes the plain version.
  """
  lead, h = x.shape[:-1], x.shape[-1]
  out = _eval_dispatch(x, ffn_block_cuda, ffn_block_plain, ffn_block_ref,
                       (x.reshape(-1, h), w1, b1, w2, b2, gamma, beta),
                       dict(eps=eps, compute_dtype=compute_dtype))
  return out.reshape(*lead, h)


# ---------------------------------------------------------------------------
# Train path: the block with a pre-scaled dropout mask ``drop`` ([R, H],
# values 0 or 1/(1-p)) on ffn_out before the residual.  The forward (B2)
# also returns inter and z for the backward (B3); the weight gradients
# (K = R products and row sums) are plain GEMMs, as they were XLA on the
# TPU (mmt_tpu/ops/ffn.py:725-748).
# ---------------------------------------------------------------------------


def ffn_train_fwd_plain(x, drop, w1, b1, w2, b2, gamma, beta, *, eps,
                        compute_dtype):
  """Plain version of B2: x, drop [R, H] -> (out fp32 [R, H],
  inter cd [R, I], z cd [R, H])."""
  cd = compute_dtype
  u = x.to(cd).float() @ w1.to(cd).float().T + b1.float()
  g = gelu_erf(u).to(cd).float()
  z = (g @ w2.to(cd).float().T + b2.float()) * drop.float() + x.float()
  return layer_norm(z, gamma, beta, eps=eps), u.to(cd), z.to(cd)


def ffn_train_fwd_cuda(x, drop, w1, b1, w2, b2, gamma, beta, *, eps,
                       compute_dtype, tile=None):
  """Launch B2 (csrc/ffn_block.cu, train forward); same contract as
  ``ffn_train_fwd_plain``, with w1/w2 in the compute dtype.  ``tile`` as
  for ``ffn_block_cuda``; -1 runs the WMMA kernel on the route too."""
  r, h, i = _weight_shapes(x, w1)
  dev = _check_operands(
      "ffn_train_fwd", rows=r, h=h, i=i, compute_dtype=compute_dtype,
      tma=gemm_route(h, i, compute_dtype),
      f32=dict(x=(x, (r, h)), drop=(drop, (r, h)), b1=(b1, (i,)),
               b2=(b2, (h,)), gamma=(gamma, (h,)), beta=(beta, (h,))),
      cd=dict(w1=(w1, (i, h)), w2=(w2, (h, i))))
  out = torch.empty((r, h), dtype=torch.float32, device=dev)
  inter = torch.empty((r, i), dtype=compute_dtype, device=dev)
  z = torch.empty((r, h), dtype=compute_dtype, device=dev)
  scratch, xb, g, tile = _gemm_scratch(r, h, i, compute_dtype, tile, dev)
  _launch(_build.load_library(), "mmt_ffn_train_fwd", dev,
          x.data_ptr(), drop.data_ptr(), w1.data_ptr(), b1.data_ptr(),
          w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
          out.data_ptr(), inter.data_ptr(), z.data_ptr(), xb, g, r, h, i,
          float(eps), _DTYPE_CODES[compute_dtype], tile)
  ffn_train_fwd_cuda.launches += 1
  return out, inter, z


ffn_train_fwd_cuda.launches = 0


def ffn_train_bwd_plain(dy, z, inter, drop, w1, w2, gamma, *, eps,
                        compute_dtype, add_dz=True):
  """Plain version of B3: dy fp32 [R, H], z cd [R, H], inter cd [R, I],
  drop fp32 [R, H] -> (dx fp32 [R, H], dz cd [R, H], dinter cd [R, I]).
  ``add_dz=False`` leaves out dz from dx (the tensor-parallel partial)."""
  cd = compute_dtype
  zhat, rstd = _zhat(z.float(), eps)
  dyg = dy.float() * gamma.float()
  dz = rstd * (dyg - dyg.mean(-1, keepdim=True)
               - zhat * (dyg * zhat).mean(-1, keepdim=True))
  dffn = (dz * drop.float()).to(cd).float()
  dinter = ((dffn @ w2.to(cd).float())
            * gelu_erf_grad(inter.float())).to(cd)
  dx = dinter.float() @ w1.to(cd).float()
  return (dx + dz if add_dz else dx), dz.to(cd), dinter


def ffn_train_bwd_cuda(dy, z, inter, drop, w1, w2, gamma, *, eps,
                       compute_dtype, add_dz=True, tile=None):
  """Launch B3 (csrc/ffn_train_bwd.cu); same contract as
  ``ffn_train_bwd_plain``, with w1/w2 in the compute dtype.  ``tile`` as
  for ``ffn_train_fwd_cuda``."""
  r, h, i = _weight_shapes(z, w1)
  dev = _check_operands(
      "ffn_train_bwd", rows=r, h=h, i=i, compute_dtype=compute_dtype,
      tma=gemm_route(h, i, compute_dtype),
      f32=dict(dy=(dy, (r, h)), drop=(drop, (r, h)), gamma=(gamma, (h,))),
      cd=dict(z=(z, (r, h)), inter=(inter, (r, i)), w1=(w1, (i, h)),
              w2=(w2, (h, i))))
  dx = torch.empty((r, h), dtype=torch.float32, device=dev)
  dz = torch.empty((r, h), dtype=compute_dtype, device=dev)
  dinter = torch.empty((r, i), dtype=compute_dtype, device=dev)
  scratch, dffn, w1t, w2t, tile = _bwd_scratch(r, h, i, compute_dtype, tile,
                                               dev)
  _launch(_build.load_library(), "mmt_ffn_train_bwd", dev,
          dy.data_ptr(), z.data_ptr(), inter.data_ptr(), drop.data_ptr(),
          w1.data_ptr(), w2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
          dz.data_ptr(), dinter.data_ptr(), dffn, w1t, w2t, r, h, i,
          float(eps), _DTYPE_CODES[compute_dtype], int(bool(add_dz)), tile)
  ffn_train_bwd_cuda.launches += 1
  return dx, dz, dinter


ffn_train_bwd_cuda.launches = 0


def ffn_train_weight_grads(x, dy, z, inter, drop, dz, dinter, *, eps,
                           compute_dtype):
  """dW1 [I, H], db1 [I], dW2 [H, I], db2 [H], dgamma [H], dbeta [H], all
  fp32, from the forward's residuals and B3's outputs.  The products take
  the compute-dtype-rounded operands with fp32 accumulation, as the JAX
  package's dot_generals with preferred_element_type=float32."""
  cd = compute_dtype
  dy = dy.float()
  zhat, _ = _zhat(z.float(), eps)
  dffn = dz.float() * drop.float()
  gelu_out = gelu_erf(inter.float()).to(cd).float()
  dinter = dinter.float()
  dw2 = dffn.to(cd).float().T @ gelu_out
  dw1 = dinter.T @ x.to(cd).float()
  return (dw1, dinter.sum(0), dw2, dffn.sum(0), (dy * zhat).sum(0),
          dy.sum(0))


class FFNBlockTrain(torch.autograd.Function):
  """Train-time FFN block on x [R, H] with its pre-scaled mask: B2
  forward, B3 backward (or their plain versions), plain weight gradients.

  Takes the fp32 master weights w1 [I, H] and w2 [H, I] and casts them to
  the compute dtype inside, so their gradients come back in fp32.  The
  choice between kernels and plain versions is made once, in the forward,
  and the backward follows it.  The mask gets no gradient.

  With a ``tp`` (``parallel.TensorParallel``) the weights are this rank's
  shards (w1 [I/mp, H], b1 [I/mp], w2 [H, I/mp]): the forward is B7, the
  fp32 all-reduce of its partial, + b2, * drop, + x and the LayerNorm;
  the backward B3 with add_dz=False, then dx = all-reduce(partial dx) +
  dz (dz rounded to the compute dtype, as the JAX package adds it).  dW1,
  db1 and dW2 are then this rank's shards; db2, dgamma, dbeta and dx are
  the same on every rank.
  """

  @staticmethod
  def forward(ctx, x, drop, w1, b1, w2, b2, gamma, beta, eps, compute_dtype,
              tp):
    cd = compute_dtype
    w1c, w2c = w1.to(cd).contiguous(), w2.to(cd).contiguous()
    use_kernel = ops.use_kernel(x)
    if tp is None:
      fwd = ffn_train_fwd_cuda if use_kernel else ffn_train_fwd_plain
      out, inter, z = fwd(x, drop, w1c, b1, w2c, b2, gamma, beta, eps=eps,
                          compute_dtype=cd)
    else:
      fwd = (ffn_train_fwd_partial_cuda if use_kernel
             else ffn_train_fwd_partial_plain)
      yp, inter = fwd(x, w1c, b1, w2c, compute_dtype=cd)
      z = (tp.all_reduce(yp) + b2.float()) * drop.float() + x.float()
      out, z = layer_norm(z, gamma, beta, eps=eps), z.to(cd)
    ctx.save_for_backward(x, drop, w1c, w2c, gamma, inter, z)
    ctx.eps, ctx.cd, ctx.use_kernel, ctx.tp = eps, cd, use_kernel, tp
    return out

  @staticmethod
  def backward(ctx, dy):
    x, drop, w1c, w2c, gamma, inter, z = ctx.saved_tensors
    dy = dy.float().contiguous()
    bwd = ffn_train_bwd_cuda if ctx.use_kernel else ffn_train_bwd_plain
    dx, dz, dinter = bwd(dy, z, inter, drop, w1c, w2c, gamma, eps=ctx.eps,
                         compute_dtype=ctx.cd, add_dz=ctx.tp is None)
    if ctx.tp is not None:
      dx = ctx.tp.all_reduce(dx) + dz.float()
    grads = ffn_train_weight_grads(x, dy, z, inter, drop, dz, dinter,
                                   eps=ctx.eps, compute_dtype=ctx.cd)
    return (dx, None, *grads, None, None, None)


# ---------------------------------------------------------------------------
# Tensor parallelism.  On a rank of a tensor-parallel group the FFN weights
# are its shards (models/bert.py): w1 [I/mp, H] and b1 [I/mp] column-
# parallel, w2 [H, I/mp] row-parallel.  The second product is then a partial
# sum over the inner dim, so the partial kernels (B6 eval, B7 train
# forward) stop before b2 and write the unreduced fp32 partial; the blocks
# all-reduce it in fp32 and finish b2, the mask, the residual and the
# LayerNorm in PyTorch (mmt_tpu/ops/ffn.py:_tp_lower, _tp_fwd, _tp_bwd).
# The train backward is B3 with add_dz=False.
# ---------------------------------------------------------------------------


def ffn_train_fwd_partial_plain(x, w1, b1, w2, *, compute_dtype):
  """Plain version of B7: x [R, H] -> (the unreduced fp32 partial
  GELU(x w1^T + b1) w2^T [R, H], inter = x w1^T + b1 cd [R, I])."""
  cd = compute_dtype
  u = x.to(cd).float() @ w1.to(cd).float().T + b1.float()
  return gelu_erf(u).to(cd).float() @ w2.to(cd).float().T, u.to(cd)


def ffn_partial_plain(x, w1, b1, w2, *, compute_dtype):
  """Plain version of B6: x [R, H] -> the unreduced fp32 partial [R, H]."""
  return ffn_train_fwd_partial_plain(x, w1, b1, w2,
                                     compute_dtype=compute_dtype)[0]


def ffn_partial_ref(x, w1, b1, w2, *, compute_dtype):
  """``ffn_block_ref`` on this rank's shards up to its second product,
  returned in fp32: the backward of B6, as the JAX package's is the vjp of
  its sharded XLA reference."""
  cd = compute_dtype
  return (gelu_erf(x.to(cd) @ w1.to(cd).T + b1.to(cd)) @ w2.to(cd).T).float()


def ffn_partial_cuda(x, w1, b1, w2, *, compute_dtype, tile=None):
  """Launch B6 (csrc/ffn_block.cu, partial); same contract as
  ``ffn_partial_plain``, with w1/w2 in the compute dtype; ``tile`` as for
  ``ffn_block_cuda``."""
  r, h, i = _weight_shapes(x, w1)
  dev = _check_operands(
      "ffn_partial", rows=r, h=h, i=i, compute_dtype=compute_dtype,
      tma=gemm_route(h, i, compute_dtype),
      f32=dict(x=(x, (r, h)), b1=(b1, (i,))),
      cd=dict(w1=(w1, (i, h)), w2=(w2, (h, i))))
  out = torch.empty((r, h), dtype=torch.float32, device=dev)
  scratch, xb, g, tile = _gemm_scratch(r, h, i, compute_dtype, tile, dev)
  _launch(_build.load_library(), "mmt_ffn_partial", dev, x.data_ptr(),
          w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(), xb, g,
          r, h, i, _DTYPE_CODES[compute_dtype], tile)
  ffn_partial_cuda.launches += 1
  return out


ffn_partial_cuda.launches = 0


def ffn_train_fwd_partial_cuda(x, w1, b1, w2, *, compute_dtype, tile=None):
  """Launch B7 (csrc/ffn_block.cu, train partial); same contract as
  ``ffn_train_fwd_partial_plain``, with w1/w2 in the compute dtype.
  ``tile`` as for ``ffn_train_fwd_cuda``."""
  r, h, i = _weight_shapes(x, w1)
  dev = _check_operands(
      "ffn_train_fwd_partial", rows=r, h=h, i=i, compute_dtype=compute_dtype,
      tma=gemm_route(h, i, compute_dtype),
      f32=dict(x=(x, (r, h)), b1=(b1, (i,))),
      cd=dict(w1=(w1, (i, h)), w2=(w2, (h, i))))
  out = torch.empty((r, h), dtype=torch.float32, device=dev)
  inter = torch.empty((r, i), dtype=compute_dtype, device=dev)
  scratch, xb, g, tile = _gemm_scratch(r, h, i, compute_dtype, tile, dev)
  _launch(_build.load_library(), "mmt_ffn_train_fwd_partial", dev,
          x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
          out.data_ptr(), inter.data_ptr(), xb, g, r, h, i,
          _DTYPE_CODES[compute_dtype], tile)
  ffn_train_fwd_partial_cuda.launches += 1
  return out, inter


ffn_train_fwd_partial_cuda.launches = 0


def ffn_block_tp(x, w1, b1, w2, b2, gamma, beta, *, eps, tp,
                 compute_dtype=torch.bfloat16):
  """Tensor-parallel FFN sub-block over [..., H] on this rank's shards
  (``tp`` a ``parallel.TensorParallel``); returns fp32 [..., H], the same
  on every rank.  B6 (same dispatch rule as ``ffn_block``), the fp32
  all-reduce of its partial, then + b2 + x and the LayerNorm."""
  lead, h = x.shape[:-1], x.shape[-1]
  x2 = x.reshape(-1, h)
  part = _eval_dispatch(x, ffn_partial_cuda, ffn_partial_plain,
                        ffn_partial_ref, (x2, w1, b1, w2),
                        dict(compute_dtype=compute_dtype))
  y = tp_lib.reduce_from_tp(part, tp)
  out = layer_norm(y + b2.float() + x2.float(), gamma, beta, eps=eps)
  return out.reshape(*lead, h)


def ffn_block_train(x, drop, w1, b1, w2, b2, gamma, beta, *, eps,
                    compute_dtype=torch.bfloat16, tp=None):
  """Train-time FFN sub-block over [..., H] with the pre-scaled dropout
  mask ``drop`` (same shape as x, fp32); returns fp32 [..., H].

  Same dispatch rule as ``ffn_block``: a CUDA tensor launches B2 and, in
  the backward, B3 (each raises on what it does not take); a CPU tensor
  takes the plain versions.  w1/w2 are the fp32 master weights.  With a
  ``tp`` (``parallel.TensorParallel``) they are this rank's shards and
  the forward launches B7 instead of B2.
  """
  lead, h = x.shape[:-1], x.shape[-1]
  out = FFNBlockTrain.apply(
      x.reshape(-1, h).contiguous(), drop.reshape(-1, h).float().contiguous(),
      w1, b1, w2, b2, gamma, beta, eps, compute_dtype, tp)
  return out.reshape(*lead, h)
