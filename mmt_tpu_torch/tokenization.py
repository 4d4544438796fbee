"""Self-contained WordPiece tokenizer (no HuggingFace dependency).

Port of mmt_tpu/tokenization.py: the reference uses
``transformers.BertTokenizer('bert-base-cased', do_lower_case=True)``
(utils/nlp_utils.py:19-42), reimplemented here from the algorithm itself
— BERT basic tokenization (lower-casing, accent stripping, punctuation
splitting, CJK spacing) + greedy longest-match WordPiece with '##'
continuation pieces, driven by a vocab.txt file.

ASCII text without NUL goes through the C++ fast path, the port's copy of
native/wordpiece.cc (``native/wordpiece.cc`` of this package, compiled at
first use by ``_build.build_host``); any other text, and a text whose
pieces overflow the output buffer, through the Python path, which gives
the same pieces.  The fast path is the default and never falls back
silently: if the library cannot be built or loaded, building a tokenizer
raises.  ``MMT_TPU_DISABLE_NATIVE=1`` selects the Python path for every
text (``0`` or unset the fast path; another value raises).  The JAX
package's word-embedding tokenizer (``WeTokenizer``, for the wo2v/grvl
text inputs) is not ported.
"""

from __future__ import annotations

import ctypes
import os
import threading
import unicodedata
import weakref
from typing import Dict, List, Optional, Sequence

from mmt_tpu_torch import _build

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"


def load_vocab(vocab_file) -> Dict[str, int]:
  vocab: Dict[str, int] = {}
  with open(vocab_file, encoding="utf-8") as f:
    for idx, line in enumerate(f):
      token = line.rstrip("\n")
      vocab[token] = idx
  return vocab


def _is_whitespace(ch: str) -> bool:
  if ch in (" ", "\t", "\n", "\r"):
    return True
  return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
  if ch in ("\t", "\n", "\r"):
    return False
  return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
  cp = ord(ch)
  # ASCII non-alnum treated as punctuation (BERT convention).
  if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
    return True
  return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
  return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
          (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
          (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
          (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
  """Whitespace/punctuation/CJK splitting with optional lower-casing."""

  def __init__(self, do_lower_case: bool = True):
    self.do_lower_case = do_lower_case

  def tokenize(self, text: str) -> List[str]:
    text = self._clean(text)
    text = self._space_cjk(text)
    tokens: List[str] = []
    for tok in text.split():
      if self.do_lower_case:
        tok = tok.lower()
        tok = self._strip_accents(tok)
      tokens.extend(self._split_punct(tok))
    return " ".join(tokens).split()

  @staticmethod
  def _clean(text: str) -> str:
    out = []
    for ch in text:
      cp = ord(ch)
      if cp == 0 or cp == 0xFFFD or _is_control(ch):
        continue
      out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)

  @staticmethod
  def _space_cjk(text: str) -> str:
    out = []
    for ch in text:
      if _is_cjk(ord(ch)):
        out.append(f" {ch} ")
      else:
        out.append(ch)
    return "".join(out)

  @staticmethod
  def _strip_accents(text: str) -> str:
    text = unicodedata.normalize("NFD", text)
    return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

  @staticmethod
  def _split_punct(token: str) -> List[str]:
    out: List[List[str]] = []
    start_new = True
    for ch in token:
      if _is_punctuation(ch):
        out.append([ch])
        start_new = True
      else:
        if start_new:
          out.append([])
          start_new = False
        out[-1].append(ch)
    return ["".join(x) for x in out]


class WordPiece:
  """Greedy longest-match-first subword splitting."""

  def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
               max_input_chars_per_word: int = 100):
    self.vocab = vocab
    self.unk_token = unk_token
    self.max_input_chars_per_word = max_input_chars_per_word

  def tokenize(self, token: str) -> List[str]:
    if len(token) > self.max_input_chars_per_word:
      return [self.unk_token]
    pieces: List[str] = []
    start = 0
    n = len(token)
    while start < n:
      end = n
      cur = None
      while start < end:
        piece = token[start:end]
        if start > 0:
          piece = "##" + piece
        if piece in self.vocab:
          cur = piece
          break
        end -= 1
      if cur is None:
        return [self.unk_token]
      pieces.append(cur)
      start = end
    return pieces


SPECIAL_TOKENS = (PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN)


def _split_on_specials(text: str, specials: Sequence[str]):
  """Yield (chunk, is_special) splitting on special-token literals
  anywhere in the text (HF PreTrainedTokenizer trie-split semantics:
  case-sensitive, before lower-casing, mid-word matches allowed)."""
  pos = 0
  while pos < len(text):
    nxt, tok = None, None
    for s in specials:
      i = text.find(s, pos)
      if i != -1 and (nxt is None or i < nxt
                      or (i == nxt and len(s) > len(tok))):
        nxt, tok = i, s
    if nxt is None:
      yield text[pos:], False
      return
    if nxt > pos:
      yield text[pos:nxt], False
    yield tok, True
    pos = nxt + len(tok)


class WordPieceTokenizer:
  """BERT-compatible tokenizer over a vocab.txt file."""

  cls_token = CLS_TOKEN
  sep_token = SEP_TOKEN
  pad_token = PAD_TOKEN
  unk_token = UNK_TOKEN

  def __init__(self, vocab_file, do_lower_case: bool = True):
    self.vocab = load_vocab(vocab_file)
    self.inv_vocab = {v: k for k, v in self.vocab.items()}
    self.basic = BasicTokenizer(do_lower_case=do_lower_case)
    self.wordpiece = WordPiece(self.vocab)
    self.vocab_size = len(self.vocab)
    self._specials = [t for t in SPECIAL_TOKENS if t in self.vocab]
    self._native = (None if _build.env_switch("MMT_TPU_DISABLE_NATIVE",
                                              False)
                    else _NativeWordPiece(vocab_file, do_lower_case))
    # Texts (chunks between special tokens) by the path that tokenized
    # them; the loader's threads share a tokenizer.
    self.texts = {"native": 0, "python": 0}
    self._texts_lock = threading.Lock()

  def tokenize(self, text: str) -> List[str]:
    # Special-token literals pass through verbatim, matched anywhere in
    # the raw text (HF tokens_trie behavior).
    if any(s in text for s in self._specials):
      out: List[str] = []
      for chunk, is_special in _split_on_specials(text, self._specials):
        if is_special:
          out.append(chunk)
        else:
          out.extend(self._tokenize_chunk(chunk))
      return out
    return self._tokenize_chunk(text)

  def _tokenize_chunk(self, text: str) -> List[str]:
    # The native path implements the ASCII subset of BERT basic
    # tokenization and reads a NUL-terminated string; other text takes
    # the full-Unicode Python path, as does an overflow (None).
    if self._native is not None and text.isascii() and "\0" not in text:
      native = self._native.tokenize(text)
      if native is not None:
        with self._texts_lock:
          self.texts["native"] += 1
        return native
    with self._texts_lock:
      self.texts["python"] += 1
    out: List[str] = []
    for tok in self.basic.tokenize(text):
      out.extend(self.wordpiece.tokenize(tok))
    return out

  def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
    unk = self.vocab[self.unk_token]
    return [self.vocab.get(t, unk) for t in tokens]

  def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
    return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

  def encode(self, text: str, max_len: Optional[int] = None,
             special_tokens: bool = True) -> List[int]:
    tokens = self.tokenize(text)
    if special_tokens:
      tokens = [self.cls_token] + tokens + [self.sep_token]
    if max_len is not None:
      tokens = tokens[:max_len]
      if special_tokens:
        tokens[-1] = self.sep_token
    return self.convert_tokens_to_ids(tokens)


_NATIVE_LIB = None


def _native_lib() -> ctypes.CDLL:
  global _NATIVE_LIB
  if _NATIVE_LIB is None:
    lib = ctypes.CDLL(str(_build.build_host("wordpiece.cc")))
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wp_tokenize.restype = ctypes.c_int
    lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int]
    lib.wp_destroy.restype = None
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    _NATIVE_LIB = lib
  return _NATIVE_LIB


class _NativeWordPiece:
  """ctypes wrapper around native/wordpiece.cc: one vocab handle, freed
  with the wrapper."""

  def __init__(self, vocab_file, do_lower_case: bool):
    self._lib = _native_lib()
    self._handle = self._lib.wp_create(str(vocab_file).encode(),
                                       int(do_lower_case))
    if not self._handle:
      raise RuntimeError(f"wp_create could not read {vocab_file}")
    weakref.finalize(self, self._lib.wp_destroy, self._handle)

  def tokenize(self, text: str) -> Optional[List[str]]:
    """The pieces of an ASCII ``text``, or None when the C side refuses
    it (non-ASCII, or more output than the buffer holds)."""
    data = text.encode()
    buf = ctypes.create_string_buffer(4 * len(data) + 4096)
    n = self._lib.wp_tokenize(self._handle, data, buf, len(buf))
    if n < 0:
      return None
    raw = buf.value.decode("ascii")
    return raw.split("\x01") if raw else []


def create_tokenizer(tokenizer_type: str, vocab_file=None):
  """Tokenizer factory (utils/nlp_utils.py:19-42 semantics).

  ``bert*`` -> WordPiece over ``vocab_file`` (defaults to the env var
  MMT_TPU_BERT_VOCAB or data/bert-base-cased-vocab.txt).  ``wo2v*`` /
  ``grvl*`` (the word-embedding tokenizer) is not ported.
  """
  if tokenizer_type.startswith("bert"):
    vocab_file = (vocab_file or os.environ.get("MMT_TPU_BERT_VOCAB")
                  or "data/bert-base-cased-vocab.txt")
    return WordPieceTokenizer(vocab_file, do_lower_case=True)
  if tokenizer_type.startswith(("wo2v", "grvl")):
    raise NotImplementedError(
        f"tokenizer {tokenizer_type!r}: the word-embedding tokenizer "
        "(WeTokenizer) is not ported yet (ROADMAP.md, queue A)")
  return None
