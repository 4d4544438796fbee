"""chip_smoke.py's train-step comparison (check_step): what it holds each
gradient to.  Plain Python on CPU tensors; the card runs it in phases 8,
10, 13 and 14."""

import importlib.util
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                REPO / "chip_smoke.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def reference_grads():
  """Vector gradients of norm ~3e-3 (the flagship's median) and the MoE
  heads' one-element biases, cancelled sums of 3e-5 to 8e-4."""
  gen = torch.Generator().manual_seed(0)
  grads = {f"layer{i}.weight": torch.randn(64, 32, generator=gen) * 7e-5
           for i in range(6)}
  grads.update({f"moe_fc_vid.m{i}.bias": torch.tensor([v])
                for i, v in enumerate((8e-4, -5e-4, 3e-4, 1e-4, 3e-5))})
  return grads


def test_one_element_gradients_are_one_vector(smoke):
  ref = reference_grads()
  got = {n: g * (1.5 if g.numel() == 1 else 1.0) for n, g in ref.items()}
  diffs = smoke.grad_diffs(got, ref)
  scalars = torch.cat([g for g in ref.values() if g.numel() == 1])
  assert set(diffs) == {f"layer{i}.weight" for i in range(6)} | {
      smoke.SCALARS}
  d, norm = diffs[smoke.SCALARS]
  assert norm == pytest.approx(float(scalars.norm()), rel=1e-6)
  assert d == pytest.approx(0.5 * float(scalars.norm()), rel=1e-6)
  assert all(d == 0 for n, (d, _) in diffs.items() if n != smoke.SCALARS)


@pytest.mark.parametrize("change,passes", [
    # bf16-sized noise: 1% on every vector, and the smallest one-element
    # gradient moved by half its value (a rounding draw over a cancelled
    # sum); the one-element gradients together move by ~1%.
    ("noise", True),
    # One vector gradient 30% off.
    ("vector", False),
    # Every one-element gradient 30% off: the group moves as a vector does.
    ("scalars", False),
    # The loss 2e-4 off.
    ("loss", False),
])
def test_bf16_step_rules(smoke, change, passes):
  ref = reference_grads()
  gen = torch.Generator().manual_seed(1)
  got = {n: g + 1e-2 * g.norm() / g.numel() ** 0.5
         * torch.randn(g.shape, generator=gen) if g.numel() > 1 else g.clone()
         for n, g in ref.items()}
  got["moe_fc_vid.m4.bias"] = ref["moe_fc_vid.m4.bias"] * 1.5
  loss = 0.05
  if change == "vector":
    got["layer3.weight"] = ref["layer3.weight"] * 1.3
  elif change == "scalars":
    got.update({n: g * 1.3 for n, g in ref.items() if g.numel() == 1})
  elif change == "loss":
    loss += 2e-4
  if passes:
    smoke.check_step(torch, "step", loss, 0.05, got, ref)
  else:
    with pytest.raises(RuntimeError):
      smoke.check_step(torch, "step", loss, 0.05, got, ref)


@pytest.mark.parametrize("rel,passes", [(1e-6, True), (1e-3, False)])
def test_fp32_step_rules(smoke, rel, passes):
  """The fp32 witness step (kernel vs plain, both float32) holds all
  gradients together to 1e-4: summation order passes, a 1e-3 error in
  every gradient does not."""
  ref = reference_grads()
  got = {n: g * (1 + rel) for n, g in ref.items()}
  if passes:
    smoke.check_step(torch, "fp32 step", 0.05, 0.05, got, ref,
                     tols=smoke.STEP_FP32_TOLS)
  else:
    with pytest.raises(RuntimeError):
      smoke.check_step(torch, "fp32 step", 0.05, 0.05, got, ref,
                       tols=smoke.STEP_FP32_TOLS)
