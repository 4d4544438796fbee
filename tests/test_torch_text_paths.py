"""The word-embedding text path of the port against the JAX package's.

``NetVLAD``, ``LSTMPooler`` and ``TxtEmbeddings`` against their flax
modules at 1e-5 (fp32), in eval and train mode, with padded tokens, rows
of length 0 and all-pad captions; ``read_word2vec`` in its three formats
and ``WeTokenizer`` ids against the JAX package's; the LSTM's per-gate
flax leaves fused into torch.nn.LSTM's tensors, held by a strict load,
by equal outputs and by the names and values of
scripts/convert_checkpoint.py:export_state_dict.
"""

import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu import tokenization as jax_tok
from mmt_tpu.models import components as flax_components
from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu_torch import convert
from mmt_tpu_torch import tokenization as port_tok
from mmt_tpu_torch.models import components as C
from mmt_tpu_torch.models.cenet import CENet
from tests.conftest import make_batch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from scripts.convert_checkpoint import export_state_dict  # noqa: E402

TOL = 1e-5


def padded_tokens(b=5, n=7, d=16, seed=0):
  """x [b, n, d] with the pads zeroed, and lengths: row 3 has none, row 4
  is whole."""
  rng = np.random.RandomState(seed)
  lengths = np.array([3, 1, 6, 0, n])[:b]
  x = rng.randn(b, n, d).astype(np.float32)
  x *= (np.arange(n)[None, :, None] < lengths[:, None, None])
  return x, lengths


def leaf_params(variables):
  return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("train", (False, True))
def test_netvlad_matches_flax(train):
  x, _ = padded_tokens()
  mod = flax_components.NetVLAD(cluster_size=28, feature_size=16)
  variables = leaf_params(mod.init(jax.random.PRNGKey(0), x))
  stats = variables["batch_stats"]["batch_norm"]["bn"]
  stats["mean"] = np.linspace(-0.1, 0.1, 28).astype(np.float32)
  stats["var"] = np.linspace(0.5, 1.5, 28).astype(np.float32)
  jvars = jax.tree_util.tree_map(jnp.asarray, variables)
  if train:
    want, mut = mod.apply(jvars, x, train=True, mutable=["batch_stats"])
  else:
    want = mod.apply(jvars, x)

  port = C.NetVLAD(28, 16, device="cpu")
  sd = convert.state_dict_from_flax(
      {"text_pooling": variables["params"]},
      {"text_pooling": variables["batch_stats"]})
  port.load_state_dict({k[len("text_pooling."):]: v for k, v in sd.items()},
                       strict=True)
  got = port(torch.from_numpy(x), train=train)
  assert got.shape == (5, 28 * 16)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=TOL, atol=TOL)
  if train:
    # The batch moments cover every one of the B * N token rows, pads
    # included, as the JAX package's ``flat`` does.
    new = mut["batch_stats"]["batch_norm"]["bn"]
    np.testing.assert_allclose(port.batch_norm.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.batch_norm.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-6, atol=1e-6)


def test_lstm_pooler_matches_flax_with_zero_lengths():
  """A row of length 0 reads what flax's nn.RNN(seq_lengths=0) carries
  out: index seq_lengths - 1 = -1, the state after all T padded steps
  (not the zero state: with nonzero biases it moves on zero inputs);
  torch's pack_padded_sequence would refuse the row."""
  x, lengths = padded_tokens()
  mod = flax_components.LSTMPooler(hidden_dim=24, output_dim=12)
  variables = leaf_params(mod.init(jax.random.PRNGKey(0), x, lengths))
  params = variables["params"]
  params["fc"]["bias"] = np.linspace(-1, 1, 12).astype(np.float32)
  for gate in ("hi", "hf", "hg", "ho"):
    cell = params["OptimizedLSTMCell_0"][gate]
    cell["bias"] = np.random.RandomState(1).randn(24).astype(np.float32)
  want = np.asarray(mod.apply(
      {"params": jax.tree_util.tree_map(jnp.asarray, params)}, x, lengths))

  port = C.LSTMPooler(16, 24, 12, device="cpu")
  sd = convert.state_dict_from_flax({"text_pooling": params}, {})
  assert set(sd) == {f"text_pooling.{k}" for k in port.state_dict()}
  port.load_state_dict({k[len("text_pooling."):]: v for k, v in sd.items()},
                       strict=True)
  got = port(torch.from_numpy(x), torch.from_numpy(lengths))
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
  assert np.abs(want[3] - params["fc"]["bias"]).max() > 1e-3
  # The input-side bias stays at zero: flax has one bias a gate.
  assert not port.lstm.bias_ih_l0.requires_grad
  assert not port.lstm.bias_ih_l0.any()


def test_txt_embeddings_read_row_zero_as_zero():
  rng = np.random.RandomState(0)
  ids = rng.randint(0, 9, size=(4, 6))
  ids[2] = 0                                     # an all-pad caption
  mod = flax_components.TxtEmbeddings(vocab_size=9, emb_dim=5)
  variables = leaf_params(mod.init(jax.random.PRNGKey(0), ids))
  table = variables["params"]["word_embeddings"].copy()
  table[0] = 7.0                                 # whatever the table holds
  want = np.asarray(mod.apply(
      {"params": {"word_embeddings": jnp.asarray(table)}}, ids))
  port = C.TxtEmbeddings(9, 5, device="cpu")
  sd = convert.state_dict_from_flax(
      {"word_embeddings": {"word_embeddings": table}}, {})
  port.load_state_dict({"word_embeddings.weight":
                        sd["word_embeddings.word_embeddings.weight"]},
                       strict=True)
  tids = torch.from_numpy(ids)
  got = port(tids)
  np.testing.assert_array_equal(got.detach().numpy(), want)
  assert not got[2].any()
  got.sum().backward()
  assert not port.word_embeddings.weight.grad[0].any()


def write_vectors(tmp_path, words, vecs):
  """The same vectors as word2vec .bin, word2vec text (with a header) and
  GloVe text (without one)."""
  n, d = vecs.shape
  binary = tmp_path / "vectors.bin"
  with open(binary, "wb") as f:
    f.write(f"{n} {d}\n".encode())
    for w, v in zip(words, vecs):
      f.write(w.encode() + b" " + v.astype(np.float32).tobytes() + b"\n")
  rows = [f"{w} " + " ".join(repr(float(x)) for x in v)
          for w, v in zip(words, vecs)]
  text = tmp_path / "vectors.txt"
  text.write_text(f"{n} {d}\n" + "\n".join(rows) + "\n")
  glove = tmp_path / "glove.txt"
  glove.write_text("\n".join(rows) + "\n")
  return binary, text, glove


def test_read_word2vec_formats_and_ids_match_jax(tmp_path):
  from mmt_tpu_torch.data.synthetic import FILLER, TOPICS
  words = sorted(set(TOPICS + FILLER))
  vecs = np.random.RandomState(0).randn(len(words), 6).astype(np.float32)
  for path in write_vectors(tmp_path, words, vecs):
    got_words, got = port_tok.read_word2vec(path)
    want_words, want = jax_tok.read_word2vec(path)
    assert got_words == want_words == words, path.name
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vecs)

    port, jaxt = port_tok.WeTokenizer(path), jax_tok.WeTokenizer(path)
    np.testing.assert_array_equal(port.weights, jaxt.weights)
    assert not port.weights[:2].any()
    assert (port.vocab_size, port.text_dim) == (jaxt.vocab_size, jaxt.text_dim)
    texts = ["A man cooks.", "the dog RUNS, fast!!", "zzz qqq",
             f"{words[3]} {words[7]}-{words[1]} {words[2].upper()}"]
    for text in texts:
      assert port.tokenize(text) == jaxt.tokenize(text), text
      ids = port.convert_tokens_to_ids(port.tokenize(text))
      assert ids == jaxt.convert_tokens_to_ids(jaxt.tokenize(text)), text
      assert port.convert_ids_to_tokens(ids) == jaxt.convert_ids_to_tokens(
          ids)


def test_lstm_gates_through_the_cenet_and_the_exporter(tiny_arch):
  """A word-vector LSTM CENet with collaborative gating: the flax tree
  converted by the port equals scripts/convert_checkpoint.py:
  export_state_dict's names and values (fused gates i, f, g, o; the
  hidden-side biases as bias_hh, bias_ih zero), loads strict, and gives
  the flax model's outputs."""
  arch = dict(tiny_arch, txt_agg="lstm", txt_inp="wo2vftn", we_vocab_size=30,
              we_dim=8, vid_cont="coll", vid_inp="agg", vid_wgh="nrm")
  batch = make_batch(arch["expert_dims"], b=3, k=2, t=6, l=4, vocab=30)
  batch["token_ids"][1, 0, 2:, :] = 0
  batch["token_ids"][2, 1, :, :] = 0            # a padded caption slot
  model = FlaxCENet(**arch)
  variables = leaf_params(model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False))
  params, stats = variables["params"], variables["batch_stats"]
  sd = convert.state_dict_from_flax(params, stats)
  exported, unexported = export_state_dict(params, stats, with_pooler=False)
  assert not unexported
  assert set(sd) == set(exported)
  for name, value in exported.items():
    np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)

  port = CENet(**arch, device="cpu").eval()
  port.load_state_dict(sd, strict=True)
  want = model.apply(jax.tree_util.tree_map(jnp.asarray, variables), batch)
  from mmt_tpu_torch.flagship import batch_to_torch
  with torch.inference_mode():
    got = port(batch_to_torch(batch, "cpu"))
  for key in ("text_embds", "text_weights", "vid_embds", "vid_weights"):
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-4, atol=1e-4, err_msg=key)
