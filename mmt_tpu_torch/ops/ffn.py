"""Fused transformer FFN sub-block: LN(x + GELU_erf(x W1^T + b1) W2^T + b2).

Port of mmt_tpu/ops/ffn.py (``ffn_block``, ``layer_norm``).  On the card
the block is one hand-written CUDA kernel (csrc/ffn_block.cu) that keeps
the [R, I] intermediate out of device memory; ``ffn_block_plain`` is the
same arithmetic in plain PyTorch.  Both mirror the TPU kernel's numerics
(not the XLA reference's, which keeps bias and GELU in the compute type):
operands rounded to the compute dtype, fp32 accumulation, fp32 bias and
exact erf-GELU, the GELU output rounded to the compute dtype, then fp32
residual + LayerNorm with the fast-variance form.

Weights use nn.Linear's layout: w1 [I, H], w2 [H, I].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmt_tpu_torch import _build, ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gelu_erf(x):
  """Exact (erf) GELU, as the reference's BERT uses."""
  return F.gelu(x, approximate="none")


def layer_norm(y, gamma, beta, *, eps):
  """fp32 LayerNorm with flax's fast-variance form (mean(y^2) - mean^2,
  clamped at 0)."""
  y = y.float()
  mean = y.mean(-1, keepdim=True)
  mean2 = (y * y).mean(-1, keepdim=True)
  var = (mean2 - mean * mean).clamp_min(0.0)
  y = (y - mean) * torch.rsqrt(var + eps)
  return y * gamma.float() + beta.float()


def ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, *, eps, compute_dtype):
  """Plain PyTorch version of the kernel: x [R, H] -> fp32 [R, H]."""
  cd = compute_dtype
  inter = x.to(cd).float() @ w1.to(cd).float().T + b1.float()
  inter = gelu_erf(inter).to(cd).float()
  y = inter @ w2.to(cd).float().T + b2.float() + x.float()
  return layer_norm(y, gamma, beta, eps=eps)


def _require(cond, msg):
  if not cond:
    raise ValueError(f"ffn_block kernel: {msg}")


def ffn_block_cuda(x, w1, b1, w2, b2, gamma, beta, *, eps, compute_dtype):
  """Launch csrc/ffn_block.cu on x [R, H] (CUDA); returns fp32 [R, H]."""
  args = (x, w1, b1, w2, b2, gamma, beta)
  _require(all(t.is_cuda and t.device == x.device for t in args),
           "every operand must lie on the same CUDA device")
  _require(x.dim() == 2, f"x must be [R, H], got {tuple(x.shape)}")
  r, h = x.shape
  i = w1.shape[0]
  _require(compute_dtype in _DTYPE_CODES,
           f"compute dtype {compute_dtype} not supported")
  _require(w1.dtype == compute_dtype and w2.dtype == compute_dtype,
           f"weights must be {compute_dtype}, got {w1.dtype}/{w2.dtype}")
  _require(all(t.dtype == torch.float32 for t in (x, b1, b2, gamma, beta)),
           "x, biases and LayerNorm parameters must be float32")
  _require(tuple(w1.shape) == (i, h) and tuple(w2.shape) == (h, i)
           and tuple(b1.shape) == (i,)
           and all(tuple(t.shape) == (h,) for t in (b2, gamma, beta)),
           "shapes must be x [R, H], w1 [I, H], b1 [I], w2 [H, I], "
           "b2/gamma/beta [H]")
  _require(h % 16 == 0 and 0 < h <= 1024 and i % 16 == 0 and i > 0,
           f"needs H % 16 == 0, H <= 1024 and I % 16 == 0 (H={h}, I={i})")
  _require(all(t.is_contiguous() for t in args), "operands must be contiguous")
  _require(w1.data_ptr() % 32 == 0 and w2.data_ptr() % 32 == 0,
           "weights must be 32-byte aligned")
  out = torch.empty((r, h), dtype=torch.float32, device=x.device)
  lib = _build.load_library()
  with torch.cuda.device(x.device):
    code = lib.mmt_ffn_block(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), r, h, i, float(eps), _DTYPE_CODES[compute_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(lib, "mmt_ffn_block", code)
  ffn_block_cuda.launches += 1
  return out


ffn_block_cuda.launches = 0


def ffn_block(x, w1, b1, w2, b2, gamma, beta, *, eps,
              compute_dtype=torch.bfloat16):
  """Fused FFN sub-block over [..., H] input; returns fp32 [..., H].

  A CUDA tensor launches the kernel (which raises on what it does not
  take); a CPU tensor takes the plain version.
  """
  lead, h = x.shape[:-1], x.shape[-1]
  x2 = x.reshape(-1, h)
  fn = ffn_block_cuda if ops.use_kernel(x) else ffn_block_plain
  out = fn(x2, w1, b1, w2, b2, gamma, beta, eps=eps,
           compute_dtype=compute_dtype)
  return out.reshape(*lead, h)
