"""The port's tensor parallelism against the JAX package's.

The JAX side runs on the 8-device virtual CPU mesh (4 x 2, data x model)
with the parameters placed by ``mesh_lib.param_shardings``; the port's
side on two gloo ranks started by ``parallel.spawn``, each holding its
shards (the rank functions are in tests/torch_tp_ranks.py).  Both get
the same numpy inputs; fp32 throughout, every dropout rate 0 where the
two packages meet.  Tolerances:

- the sharding rule: the same split, parameter by parameter;
- the TP FFN blocks (Pallas interpreted on the JAX side, the
  test_parallel.py:714 and :759 patterns): the eval output 1e-5; the
  train block's gradients rtol 2e-4 / atol 2e-5, which leaves room for
  the JAX backward kernel's A&S erf against the port's exact erf;
- the tiny CENet under TP (the :902 pattern, train-mode BatchNorm): the
  eval outputs 1e-4 and one train step's gradients 1e-4 (fp32 sum-order
  noise through two 2-layer towers, as in test_torch_train_step.py), the
  loss 1e-6 relative; against the port's single-device step the same;
- the replicated parameters after two Adam steps: bitwise equal across
  the ranks; the tiny flagship made with ``tp``: its gathered state dict
  bitwise equal to the single-device one.

One group of two ranks runs every rank-side check (``all_checks``), once
per module.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.ops import ffn as jax_ffn
from mmt_tpu.parallel import mesh as mesh_lib
from mmt_tpu.train import losses as flax_losses
from mmt_tpu_torch import convert, flagship, parallel
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.train import losses, optim, step
from tests import torch_tp_ranks
from tests.conftest import make_batch

MP = 2
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
TIMEOUT = 120.0


def _no_dropout(tiny_arch):
  arch = dict(tiny_arch)
  arch["vid_bert_params"] = {**tiny_arch["vid_bert_params"], **NO_DROPOUT}
  arch["txt_bert_params"] = dict(NO_DROPOUT)
  return arch


def _torch_names(tree, stats):
  """Flax tree -> {port name: numpy}, BN buffers left out."""
  sd = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                    stats)
  return {k: v.numpy() for k, v in sd.items()
          if not k.endswith(("num_batches_tracked", "running_mean",
                             "running_var"))}


def _ffn_inputs(seed):
  """The test_parallel.py:714 / :759 recipe: JAX-layout numpy args and a
  dropout mask."""
  rng = np.random.RandomState(seed)
  r, h, i = 16, 32, 64
  x = rng.randn(r, h).astype(np.float32)
  drop = (rng.rand(r, h) > 0.1).astype(np.float32) / 0.9
  w1 = (rng.randn(h, i) * 0.05).astype(np.float32)
  b1 = rng.randn(i).astype(np.float32)
  w2 = (rng.randn(i, h) * 0.05).astype(np.float32)
  b2 = rng.randn(h).astype(np.float32)
  gamma = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
  beta = (0.1 * rng.randn(h)).astype(np.float32)
  return (x, w1, b1, w2, b2, gamma, beta), drop


def _mesh_ffn_args(mesh, args, drop=None):
  """The FFN args placed as param_shardings places them."""
  x, w1, b1, w2, b2, gamma, beta = args
  put = lambda a, *spec: jax.device_put(a, NamedSharding(mesh, P(*spec)))
  rows = (put(x, "data", None),) + (
      () if drop is None else (put(drop, "data", None),))
  return rows + (put(w1, None, "model"), put(b1, "model"),
                 put(w2, "model", None), put(b2), put(gamma), put(beta))


@pytest.fixture(scope="module")
def flax_model(tiny_arch):
  """The tiny flax CENet (rates 0), its variables, a batch, and the
  port's state dict of the same weights."""
  arch = _no_dropout(tiny_arch)
  batch = make_batch(arch["expert_dims"], b=4, k=2, t=7, l=5, seed=3)
  model = FlaxCENet(**arch)
  variables = model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False)
  variables = jax.tree_util.tree_map(np.asarray, variables)
  sd = convert.state_dict_from_flax(variables["params"],
                                    variables["batch_stats"])
  return arch, model, variables, batch, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(flax_model, tiny_arch):
  """Every rank-side check, run once on two gloo ranks."""
  arch, _, _, batch, sd = flax_model
  fl_arch = flagship.flagship_arch(tiny=True)
  fl_batch = flagship.make_batch(fl_arch["expert_dims"], 4, vocab=512,
                                 seed=9)
  return parallel.spawn(
      torch_tp_ranks.all_checks, MP, _ffn_inputs(0),
      dict(arch=arch, state_dict=sd, batch=batch, dropout_arch=tiny_arch),
      fl_batch, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_tp(flax_model):
  """The JAX package on the 4 x 2 mesh with TP-placed parameters: the
  eval outputs, and one train step's loss and gradients."""
  arch, model, variables, batch, _ = flax_model
  mesh = mesh_lib.data_mesh(model_parallel=MP)
  params = mesh_lib.shard_params(mesh, variables["params"])
  stats = variables["batch_stats"]
  outputs = jax.jit(lambda p: model.apply(
      {"params": p, "batch_stats": stats}, batch, train=False))(params)
  loss_fn = flax_losses.max_margin_ranking_loss(0.05, True)

  def loss(p):
    out, _ = model.apply({"params": p, "batch_stats": stats}, batch,
                         train=True, rngs={"dropout": jax.random.PRNGKey(2)},
                         mutable=["batch_stats"])
    return loss_fn(flax_sims(out, merge="avg"))

  value, grads = jax.jit(jax.value_and_grad(loss))(params)
  return ({k: np.asarray(v) for k, v in outputs.items()}, float(value),
          _torch_names(grads, stats))


@pytest.fixture(scope="module")
def single_device(flax_model, tiny_arch):
  """The port's single-device step on the same weights and batch: (loss,
  grads) at rates 0 (seed 0), and at tiny_arch's rates (seed 5)."""
  arch, _, _, batch, sd = flax_model
  tb = flagship.batch_to_torch(batch, "cpu")
  runs = []
  for a, seed in ((arch, 0), (tiny_arch, 5)):
    model = CENet(**a, device="cpu").train()
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()}, strict=True)
    opt, lr = optim.build_optimizer(torch_tp_ranks.SPEC, model.parameters())
    loss = step.train_step(model, opt, tb, lr=lr,
                           generator=torch.Generator().manual_seed(seed),
                           loss_fn=losses.max_margin_ranking_loss(0.05, True))
    runs.append((float(loss), {n: p.grad.numpy().copy()
                               for n, p in model.named_parameters()}))
  return runs


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("heads", [(4, 4), (3, 4), (4, 3)])
def test_shard_rule_matches_param_shardings(flax_model, mp, heads):
  """The shard_dims of a CENet(tp=) on the tiny arch with (text, video)
  ``heads`` against mesh_lib.param_shardings with the same head counts,
  parameter by parameter (a JAX kernel [in, out] is the port's weight
  transposed, so its dim d is the port's 1 - d); 3 heads keep that
  tower's attention whole."""
  arch, _, variables, _, _ = flax_model
  txt_heads, vid_heads = heads
  num_heads = {"txt_bert": txt_heads, "vid_bert": vid_heads}
  arch = dict(arch, text_bert_geometry={**arch["text_bert_geometry"],
                                        "num_attention_heads": txt_heads},
              vid_bert_params={**arch["vid_bert_params"],
                               "num_attention_heads": vid_heads})
  got = CENet(**arch, device="cpu",
              tp=parallel.TensorParallel(rank=0, size=mp)).shard_dims
  mesh = mesh_lib.data_mesh(model_parallel=mp)
  specs = mesh_lib.param_shardings(mesh, variables["params"],
                                   num_heads=num_heads)
  want = {}
  for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]:
    name, transpose = convert._param_name("/".join(k.key for k in path))
    split = [d for d, axis in enumerate(spec.spec) if axis == "model"]
    if split:
      want[name] = 1 - split[0] if transpose else split[0]
  assert got == want
  # 2 txt + 2 vid layers: q/k/v/ffn_inter column kernels, attn_out and
  # ffn_out row kernels and the column biases (test_parallel.py:929-931);
  # a tower with 3 heads splits only its FFNs.
  weights = [d for n, d in got.items() if n.endswith("weight")]
  counts = (weights.count(0), weights.count(1),
            sum(n.endswith("bias") for n in got))
  assert counts == ((10, 6, 10) if 3 in heads else (16, 8, 16))


def test_megatron_collectives(ranks):
  """g sums forward and passes the gradient through; f passes forward
  and sums the gradient (Megatron's f and g, fp32)."""
  for r in ranks:
    c = r["collectives"]
    np.testing.assert_array_equal(c["g_value"], np.full(3, 3.0))
    np.testing.assert_array_equal(c["g_grad"], np.ones(3))
    np.testing.assert_array_equal(c["f_grad"], np.full(3, 3.0))


def test_tp_eval_ffn_matches_jax(ranks):
  args, _ = _ffn_inputs(0)
  jax_ffn.use_pallas(True, interpret=True)
  try:
    fn = lambda *a: jax_ffn.ffn_block(*a, eps=1e-12,
                                      compute_dtype=jax.numpy.float32)
    mesh = mesh_lib.data_mesh(model_parallel=MP)
    want = np.asarray(jax.jit(fn)(*_mesh_ffn_args(mesh, args)))
  finally:
    jax_ffn.use_pallas(False)
  for r in ranks:
    np.testing.assert_allclose(r["ffn"]["eval"], want, rtol=1e-5, atol=1e-5)


def test_tp_train_ffn_grads_match_jax(ranks):
  args, drop = _ffn_inputs(0)

  def loss(*a):
    out = jax_ffn.ffn_block_train(*a, eps=1e-12,
                                  compute_dtype=jax.numpy.float32)
    return jax.numpy.sum(out ** 2)

  jax_ffn.use_pallas(True, interpret=True)
  try:
    mesh = mesh_lib.data_mesh(model_parallel=MP)
    names = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")
    want = jax.jit(jax.grad(loss, argnums=(0, 2, 3, 4, 5, 6, 7)))(
        *_mesh_ffn_args(mesh, args, drop))
  finally:
    jax_ffn.use_pallas(False)
  for r in ranks:
    got = r["ffn"]["grads"]
    for name, w in zip(names, want):
      w = np.asarray(w)
      np.testing.assert_allclose(got[name], w.T if name in ("w1", "w2")
                                 else w, rtol=2e-4, atol=2e-5,
                                 err_msg=name)


def test_tp_cenet_eval_matches_jax(ranks, jax_tp):
  want = jax_tp[0]
  for r in ranks:
    got = r["cenet"]["outputs"]
    for key in ("text_embds", "vid_embds", "text_weights", "vid_weights"):
      np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                 err_msg=key)


@pytest.mark.parametrize("ref", ["jax_tp", "single_device"])
def test_tp_step_loss_matches(ranks, jax_tp, single_device, ref):
  want = jax_tp[1] if ref == "jax_tp" else single_device[0][0]
  for r in ranks:
    assert abs(r["cenet"]["loss"] - want) <= 1e-6 * abs(want), (
        r["cenet"]["loss"], want)


@pytest.mark.parametrize("ref", ["jax_tp", "single_device"])
def test_tp_step_grads_match(ranks, jax_tp, single_device, ref):
  want = jax_tp[2] if ref == "jax_tp" else single_device[0][1]
  for r in ranks:
    got = r["cenet"]["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
      np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4,
                                 err_msg=name)


def test_tp_dropout_step_matches_single_device(ranks, single_device):
  """At tiny_arch's dropout rates, the TP step from generator seed 5 is
  the single-device step from seed 5: every rank draws each mask at its
  full size in the single-device order (the attention mask sliced to its
  heads)."""
  loss, grads = single_device[1]
  for r in ranks:
    c = r["cenet"]
    assert abs(c["dropout_loss"] - loss) <= 1e-6 * abs(loss)
    for name, w in grads.items():
      np.testing.assert_allclose(c["dropout_grads"][name], w, rtol=1e-4,
                                 atol=1e-4, err_msg=name)


def test_replicated_params_equal_across_ranks_after_two_steps(ranks):
  a, b = (r["cenet"]["replicated"] for r in ranks)
  assert set(a) == set(b) and len(a) > 0
  for name in a:
    np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_flagship_tp_is_the_single_device_model_split(ranks):
  arch = flagship.flagship_arch(tiny=True)
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True)
  batch = flagship.make_batch(arch["expert_dims"], 4, vocab=512, seed=9)
  with torch.inference_mode():
    want = model(flagship.batch_to_torch(batch, "cpu"))
  state = model.state_dict()
  for r in ranks:
    got = r["flagship"]
    assert set(got["state"]) == set(state)
    for name, t in state.items():
      np.testing.assert_array_equal(got["state"][name], t.numpy(),
                                    err_msg=name)
    for key, w in want.items():
      np.testing.assert_allclose(got["outputs"][key], w.numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=key)


@pytest.mark.parametrize("fn", ["fail_on_rank_one", "hang_on_rank_one"])
def test_spawn_fails_and_stops_every_rank(fn):
  """A rank that raises, or one that never reaches a collective, fails
  the group within its timeout instead of hanging it."""
  with pytest.raises(RuntimeError, match="rank one fails" if fn.startswith(
      "fail") else "did not finish"):
    parallel.spawn(getattr(torch_tp_ranks, fn), MP, timeout=15.0)
