"""Every CENet switch of the port against the JAX package's, same weights.

One tiny CENet per case: the flax model is initialised, its BatchNorm
running statistics are made non-trivial, and its parameters are carried
over with ``convert.state_dict_from_flax`` into the port's CENet
(``strict=True``).  Both get the same numpy batch, which holds padded
caption tokens, a caption slot with no valid token and missing
modalities.  The eval forward, and the train forward with every dropout
rate 0 (the two packages' dropout streams never match), must agree at
1e-4 in fp32 (the existing CENet hold), and after the train forward the
BatchNorm running buffers at 1e-6.  The JAX FFN runs its XLA reference
(``use_pallas(False)``), as the JAX package's own CPU tests run it.
"""

import jax
import numpy as np
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu_torch import convert
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models.cenet import CENet
from tests.conftest import make_batch

WE_VOCAB, WE_DIM = 40, 16
WORD_VECTORS = dict(txt_inp="wo2vftn", we_vocab_size=WE_VOCAB, we_dim=WE_DIM)

# Every value of every switch that is not the flagship's, at least once.
CASES = {
    "bertftnmxp": dict(txt_agg="bertftnmxp"),
    "bertfrz4mnp": dict(txt_agg="bertfrz4mnp"),
    "bertscr_gem_txt_wgh_none": dict(txt_agg="bertscr", txt_pro="gem",
                                     txt_wgh="none"),
    "lin_ordr_sep": dict(txt_pro="lin", pos_enc="ordr", out_tok="sep"),
    "agg_type_mnp": dict(vid_inp="agg", pos_enc="type", out_tok="mnp"),
    "all_pos_none_emb": dict(vid_inp="all", pos_enc="none", vid_wgh="emb"),
    "coll_nrm": dict(vid_cont="coll", vid_inp="agg", vid_wgh="nrm"),
    "coll_missing_dropped": dict(vid_cont="coll", vid_inp="both",
                                 keep_missing_modalities=False),
    "none_gem_unnormalized": dict(vid_cont="none", vid_inp="agg",
                                  txt_pro="gem", vid_wgh="nrm",
                                  normalize_experts=False),
    "vlad": dict(txt_agg="vlad", **WORD_VECTORS),
    "mxp_words": dict(txt_agg="mxp", txt_pro="lin", **WORD_VECTORS),
    "lstm": dict(txt_agg="lstm", vid_cont="none", vid_inp="agg",
                 **WORD_VECTORS),
    "relu": dict(hidden_act="relu"),
    "swish": dict(hidden_act="swish", pos_enc="ordr"),
}


def arch_for(tiny_arch, case, dropout):
  """The tiny arch with the case's switches, every dropout at ``dropout``
  and 1-layer towers (``hidden_act`` goes to both towers)."""
  switches = dict(CASES[case])
  act = switches.pop("hidden_act", "gelu")
  rates = dict(hidden_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout)
  return dict(
      tiny_arch,
      vid_bert_params=dict(tiny_arch["vid_bert_params"], hidden_act=act,
                           num_hidden_layers=1, **rates),
      txt_bert_params=dict(hidden_act=act, **rates),
      text_bert_geometry=dict(tiny_arch["text_bert_geometry"],
                              num_hidden_layers=2),
      **switches)


def switch_batch(expert_dims, word_vectors):
  """A batch of 3 videos x 2 captions: padded captions (ids 0 at the
  pads), caption slot (2, 1) with no valid token, modality 's3d' missing
  from video 1 and 'rgb' from video 2."""
  vocab = WE_VOCAB if word_vectors else 100
  batch = make_batch(expert_dims, b=3, k=2, t=7, l=5, vocab=vocab)
  rng = np.random.RandomState(3)
  ids = batch["token_ids"]
  lengths = rng.randint(1, 8, size=(3, 2))
  lengths[2, 1] = 0
  mask = (np.arange(7)[None, None] < lengths[..., None]).astype(np.int32)
  ids[..., 1] = mask
  ids[..., 0] *= mask
  batch["features_ind"]["s3d"][1] = 0.0
  batch["features_ind"]["rgb"][2] = 0.0
  return batch


def flax_run(arch, batch):
  """(variables, eval outputs, train outputs, train batch_stats) of the
  flax CENet; the running statistics drawn away from 0 / 1."""
  model = FlaxCENet(**arch)
  variables = model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False)
  rng = np.random.RandomState(5)
  to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
  stats = to_np(variables.get("batch_stats", {}))

  def perturb(tree):
    for key, val in tree.items():
      if key == "mean":
        tree[key] = (rng.randn(*val.shape) * 0.1).astype(np.float32)
      elif key == "var":
        tree[key] = (np.abs(rng.randn(*val.shape)) + 0.5).astype(np.float32)
      else:
        perturb(val)
  perturb(stats)
  variables = {"params": to_np(variables["params"]), "batch_stats": stats}
  on_jax = jax.tree_util.tree_map(jax.numpy.asarray, variables)
  out = model.apply(on_jax, batch, train=False)
  train_out, mut = model.apply(on_jax, batch, train=True,
                               rngs={"dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats"])
  return (variables, to_np(out), to_np(train_out),
          to_np(mut.get("batch_stats", {})))


def port_model(arch, variables):
  model = CENet(**arch, device="cpu")
  model.load_state_dict(convert.state_dict_from_flax(
      variables["params"], variables["batch_stats"]), strict=True)
  return model


def assert_outputs(got, want, what, case):
  got = {k: v.detach().numpy() for k, v in got.items()}
  if case == "mxp_words":
    # The masked max of a caption with no valid token is finfo.min in
    # every entry: both packages give NaN embeddings there (ROADMAP.md
    # C5), and their MoE weights of it are NaN (JAX) or a one-hot (port).
    assert np.isnan(want["text_embds"][2, 1]).all()
    assert np.isnan(got["text_embds"][2, 1]).all()
    for out in (got, want):
      out["text_weights"] = out["text_weights"].copy()
      out["text_weights"][2, 1] = 0.0
  for key in ("text_embds", "vid_embds", "text_weights", "vid_weights"):
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                               err_msg=f"{what} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_matches_flax(tiny_arch, case):
  arch = arch_for(tiny_arch, case, dropout=0.0)
  batch = switch_batch(arch["expert_dims"], "we_vocab_size" in arch)
  variables, want, want_train, want_stats = flax_run(arch, batch)
  model = port_model(arch, variables)
  tb = batch_to_torch(batch, "cpu")
  with torch.inference_mode():
    got = model.eval()(tb)
  assert_outputs(got, want, "eval", case)

  gen = torch.Generator().manual_seed(0)
  got = model.train()(tb, train=True, generator=gen)
  assert_outputs(got, want_train, "train", case)
  stats = convert.state_dict_from_flax({}, want_stats)
  buffers = dict(model.named_buffers())
  assert set(stats) == {k for k in buffers if "running" in k
                        or "num_batches" in k}
  for name, value in stats.items():
    if "running" in name:
      np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                 rtol=1e-6, atol=1e-6, err_msg=name)
  # Gradients reach every trainable parameter the forward reads.
  loss = sum(v.float().nan_to_num().square().sum() for v in got.values())
  loss.backward()
  missing = [n for n, p in model.named_parameters()
             if p.requires_grad and p.grad is None
             and "position_embeddings" not in n]
  assert not missing, missing


def test_config_errors_raise_as_in_jax(tiny_arch):
  """vid_wgh='emb' without the video transformer, and vid_inp='temp' with
  it, are config errors in both packages, with the JAX package's
  messages; an unknown value or argument raises."""
  batch = switch_batch(tiny_arch["expert_dims"], False)
  no_bert = dict(vid_cont="none", vid_inp="agg", vid_wgh="emb")
  with pytest.raises(ValueError, match="vid_wgh='emb'"):
    CENet(**tiny_arch, device="cpu", **no_bert)
  with pytest.raises(ValueError, match="vid_wgh='emb'"):
    FlaxCENet(**tiny_arch, **no_bert).init(
        {"params": jax.random.PRNGKey(0)}, batch)
  model = CENet(**tiny_arch, device="cpu", vid_inp="temp").eval()
  with pytest.raises(ValueError, match="vid_inp='temp'"), \
      torch.inference_mode():
    model(batch_to_torch(batch, "cpu"))
  with pytest.raises(ValueError, match="vid_inp='temp'"):
    FlaxCENet(**tiny_arch, vid_inp="temp").init(
        {"params": jax.random.PRNGKey(0)}, batch)
  with pytest.raises(ValueError, match="vid_cont"):
    CENet(**tiny_arch, device="cpu", vid_cont="bogus")
  with pytest.raises(TypeError):
    CENet(**tiny_arch, device="cpu", no_such_switch=1)


def test_inert_knobs_are_stored(tiny_arch):
  """The reference's inert knobs are accepted and stored, and change no
  parameter."""
  knobs = dict(freeze_weights=True, mimic_ce_dims=True, concat_experts=True,
               concat_mix_experts=True, use_experts="x", use_mask="y",
               agg_dims=[1, 2], l2renorm=True, test_caption_mode="z",
               txt_inp="bertfrz")
  model = CENet(**tiny_arch, device="cpu", **knobs)
  for name, value in knobs.items():
    assert getattr(model, name) == value, name
  plain = CENet(**tiny_arch, device="cpu")
  assert ({k: v.shape for k, v in model.state_dict().items()}
          == {k: v.shape for k, v in plain.state_dict().items()})


def test_word_vector_kwargs_from_the_tokenizer(tmp_path):
  """cenet_kwargs_from_arch_args sizes the word-embedding path from the
  tokenizer (we_vocab_size, we_dim), as the JAX package does."""
  from mmt_tpu.models.cenet import cenet_kwargs_from_arch_args as jax_kwargs
  from mmt_tpu_torch.models.cenet import cenet_kwargs_from_arch_args
  from mmt_tpu_torch.tokenization import WeTokenizer
  path = tmp_path / "vectors.txt"
  path.write_text("3 4\na 1 2 3 4\nb 5 6 7 8\nc 0 0 0 1\n")
  tok = WeTokenizer(path)
  args = {"txt_agg": "vlad", "txt_inp": "wo2vfrz", "vocab_size": 9}
  got, _ = cenet_kwargs_from_arch_args(args, tok)
  want, _ = jax_kwargs(args, tok)
  assert got == want == {"txt_agg": "vlad", "txt_inp": "wo2vfrz",
                         "we_vocab_size": 5, "we_dim": 4}
