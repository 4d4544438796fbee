"""The port's WordPiece fast path (mmt_tpu_torch/native/wordpiece.cc,
bound by mmt_tpu_torch/tokenization.py) against its Python path and
against the JAX package's tokenizer.

Every comparison is of token lists and ids, exact.  Fuzzed sentences
mix ASCII words, punctuation, digits, case, over-long words, special
token literals, control characters and non-ASCII text.  The JAX
package's own fast path (native/wordpiece.cc) splits words at ASCII
control characters other than \\t, \\n and \\r where its Python path
drops them; the port's copy follows the Python path, so sentences with
such characters are held against the JAX package's Python path only.
"""

import sys
import threading

import numpy as np
import pytest

from mmt_tpu import tokenization as jax_tok
from mmt_tpu_torch import bench_loader
from mmt_tpu_torch import tokenization as port_tok
from mmt_tpu_torch.data import synthetic

CONTROL = "".join(chr(c) for c in list(range(1, 32)) + [127]
                  if chr(c) not in "\t\n\r")


def _fuzzed(seed, n, alphabet):
  """``n`` sentences of 1-12 words: vocab words, words made of
  ``alphabet``, punctuation runs and over-long words."""
  rng = np.random.RandomState(seed)
  words = (synthetic.TOPICS + synthetic.FILLER
           + ["cooks", "Painting", "SURFERS", "[CLS]", "x[SEP]y", "[MASK]",
              "don't", "e-mail", "3.14", "a" * 101, "surf" * 26])
  out = []
  for _ in range(n):
    parts = []
    for _ in range(rng.randint(1, 13)):
      r = rng.rand()
      if r < 0.6:
        parts.append(str(rng.choice(words)))
      else:
        k = rng.randint(1, 9)
        parts.append("".join(rng.choice(list(alphabet), k)))
    seps = rng.choice([" ", "  ", "\t", "\n", " \r\n", ""], len(parts))
    out.append("".join(p + s for p, s in zip(parts, seps)))
  return out


ASCII = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
         "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ ")
NON_ASCII = "éüñ中文Ωß—“” 　�́"


@pytest.fixture(scope="module", params=("synthetic", "large"))
def vocab(request, tmp_path_factory):
  path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
  if request.param == "synthetic":
    synthetic.write_vocab(path)
  else:
    synthetic.write_large_vocab(path)
  return path


@pytest.fixture(scope="module")
def pair(vocab):
  return bench_loader.tokenizers(vocab)


def _jax_python(vocab):
  tok = jax_tok.WordPieceTokenizer(vocab)
  tok._native = None
  return tok


@pytest.mark.parametrize("alphabet,seed", ((ASCII, 0), (ASCII + CONTROL, 1),
                                           (ASCII + NON_ASCII, 2)),
                         ids=("ascii", "control", "non_ascii"))
def test_native_equals_the_python_path(pair, alphabet, seed):
  native, python = pair["native"], pair["python"]
  assert native._native is not None and python._native is None
  for text in _fuzzed(seed, 300, alphabet):
    assert native.tokenize(text) == python.tokenize(text), repr(text)
    assert (native.encode(text, max_len=16)
            == python.encode(text, max_len=16)), repr(text)


@pytest.mark.parametrize("alphabet,seed", ((ASCII, 3), (ASCII + CONTROL, 4),
                                           (ASCII + NON_ASCII, 5)),
                         ids=("ascii", "control", "non_ascii"))
def test_native_equals_the_jax_tokenizer(vocab, pair, alphabet, seed):
  """Against the JAX package's tokenizer as it runs (its fast path where
  it loads) on text without control characters, and against its Python
  path on every text."""
  native = pair["native"]
  jax_default = jax_tok.WordPieceTokenizer(vocab)
  jax_python = _jax_python(vocab)
  for text in _fuzzed(seed, 300, alphabet):
    want = jax_python.encode(text, max_len=16)
    assert native.encode(text, max_len=16) == want, repr(text)
    if not any(c in CONTROL for c in text):
      assert jax_default.encode(text, max_len=16) == want, repr(text)


def test_control_characters_are_dropped_not_split(pair, vocab):
  native, python = pair["native"], pair["python"]
  for text in ("a man\x0bcooks", "a man\x01cooks", "surf\x7fing",
               "a\x1cman", "dog\x0c"):
    assert native._native.tokenize(text) is not None
    assert native.tokenize(text) == python.tokenize(text), repr(text)
    assert native.tokenize(text) == _jax_python(vocab).tokenize(text)


def test_which_texts_take_the_python_path(tmp_path):
  """Non-ASCII text and text with a NUL (the C side reads a
  NUL-terminated string) take the Python path, per text; so does a text
  whose pieces overflow the C side's buffer.  The tokens are the same."""
  pair = bench_loader.tokenizers(synthetic.write_vocab(tmp_path / "v.txt"))
  native, python = pair["native"], pair["python"]
  cases = [("a man cooks", "native"), ("café man", "python"),
           ("a man\x00cooks", "python"), ("[CLS] a man [SEP]", "native")]
  for text, path in cases:
    before = dict(native.texts)
    assert native.tokenize(text) == python.tokenize(text)
    grew = {k: native.texts[k] - before[k] for k in before}
    assert grew[path] >= 1 and sum(grew.values()) == grew[path], text

  native._native.tokenize = lambda text: None          # an overflow
  before = native.texts["python"]
  assert native.tokenize("a man cooks") == ["a", "man", "cook", "##s"]
  assert native.texts["python"] == before + 1


def test_the_c_side_refuses_what_it_cannot_hold(tmp_path):
  import ctypes
  tok = port_tok.WordPieceTokenizer(synthetic.write_vocab(tmp_path / "v.txt"))
  lib, handle = tok._native._lib, tok._native._handle
  buf = ctypes.create_string_buffer(4)
  assert lib.wp_tokenize(handle, b"a man cooks", buf, len(buf)) == -1
  buf = ctypes.create_string_buffer(64)
  assert lib.wp_tokenize(handle, "café".encode(), buf, len(buf)) == -2
  n = lib.wp_tokenize(handle, b"a man cooks", buf, len(buf))
  assert buf.value.split(b"\x01") == [b"a", b"man", b"cook", b"##s"]
  assert n == len(buf.value)


def test_threads_share_a_tokenizer(vocab):
  """Loader threads share one tokenizer: concurrent calls give the
  single-threaded tokens, and the per-path text counts lose no update."""
  tok = bench_loader.tokenizers(vocab)["native"]
  texts = _fuzzed(6, 200, ASCII + NON_ASCII)
  want = [tok.tokenize(t) for t in texts]
  per_pass = sum(tok.texts.values())     # chunks between special tokens
  errors = []

  def work():
    try:
      for _ in range(5):
        if [tok.tokenize(t) for t in texts] != want:
          errors.append("tokens differ")
    except Exception as e:  # reported by the main thread
      errors.append(repr(e))

  prev = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
  finally:
    sys.setswitchinterval(prev)
  assert not any(t.is_alive() for t in threads)
  assert not errors, errors[:3]
  assert sum(tok.texts.values()) == per_pass * (1 + 16 * 5)


def test_bench_queries_are_the_serving_phase_words():
  """The loader bench's query strings use chip_smoke.py's phase-12 words."""
  import importlib.util
  import pathlib
  path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
  spec = importlib.util.spec_from_file_location("chip_smoke_words", path)
  smoke = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(smoke)
  assert bench_loader.QUERY_WORDS == smoke.SERVE_WORDS
