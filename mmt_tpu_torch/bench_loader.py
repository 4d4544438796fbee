"""Input-pipeline throughput of the port's loader and tokenizer.

    python -m mmt_tpu_torch.bench_loader [--cut c|jsfusion] [--workers 0,1,2,8]

The protocol of scripts/bench_loader.py: the flagship's 7 experts at
their widths, batch 32, ``max_expert_tokens`` 30 below ``max_feats`` 40
(training draws random row picks: the path the per-record block memo
never caches), 200 synthetic videos from the port's ``data/synthetic.py``.
It adds eval mode, a cold and a warm record cache, more worker counts and
the tokenizer alone:

- train-mode samples/s and eval-mode videos/s, for each worker count, on
  the Python path (``MMT_TPU_NATIVE_ASSEMBLY=0`` with the Python
  tokenizer, what the loader ran before the native path) and on the
  native path (the C++ assembler and WordPiece fast path, the default),
  each twice in the order python, native, native, python (the mean and
  both runs are printed).  Cold: a new loader with an empty record
  cache, over as many samples as the split holds; warm: after ``--warm``
  batches (train) or one pass (eval) through the same loader.
- tokenizer texts/s, Python and native: the corpus's captions through
  ``sample.tokenize_caption`` (as the loader calls it), and
  serving-shaped queries (5 of ``QUERY_WORDS``, the words of
  ``chip_smoke.py``'s phase 12) over their own vocab, as the query
  engine calls it.

It measures the host only and needs no card: it runs on the CPU as well.
Cut ``c`` (the default) writes pickles and needs no ``h5py``; cut
``jsfusion`` writes the per-video h5 files that scripts/bench_loader.py
reads.  Prints one line per measurement and, last, one JSON object with
every rate.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np

FLAGSHIP_EXPERTS = {"face": 512, "ocr": 300, "rgb": 2048, "s3d": 1024,
                    "scene": 2208, "speech": 300, "vggish": 128}
# Cut c's pickle layout files these four under "<name>_c"; the corpus
# takes those names there, so every expert reads its own tables.
RENAMED_IN_CUT_C = ("face", "ocr", "scene", "speech")
QUERY_WORDS = ("person cooking pasta kitchen soccer match goal rain city "
               "night dog park guitar song stage car road mountain beach "
               "man woman sings runs").split()
# (train split, eval split) of each cut.
SPLITS = {"c": ("trainval", "train"), "jsfusion": ("trainval", "test")}
# Each cell runs both paths twice, in turns; a rate is the mean of two.
ORDER = ("python", "native", "native", "python")
MAX_TEXT_WORDS = 30


def corpus_experts(cut: str):
  if cut != "c":
    return dict(FLAGSHIP_EXPERTS)
  return {(m + "_c" if m in RENAMED_IN_CUT_C else m): d
          for m, d in FLAGSHIP_EXPERTS.items()}


PYTHON_PATH_ENV = {"MMT_TPU_NATIVE_ASSEMBLY": "0",
                   "MMT_TPU_DISABLE_NATIVE": "1"}


@contextlib.contextmanager
def python_path():
  """The loader's and the tokenizer's Python paths, through their
  environment switches, for the block (the assembler's choice is read
  again on entry and on exit)."""
  from mmt_tpu_torch.data import native_assembler as nasm
  prev = {k: os.environ.get(k) for k in PYTHON_PATH_ENV}
  os.environ.update(PYTHON_PATH_ENV)
  nasm.set_enabled(None)
  try:
    yield
  finally:
    for k, v in prev.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    nasm.set_enabled(None)


def tokenizers(vocab_file):
  """{"python": ..., "native": ...} WordPiece tokenizers over one vocab."""
  from mmt_tpu_torch.tokenization import WordPieceTokenizer
  with python_path():
    python = WordPieceTokenizer(vocab_file)
  return {"python": python, "native": WordPieceTokenizer(vocab_file)}


def _mix(data_dir, cut, split, max_expert_tokens):
  return [{"dataset_name": "MSRVTT", "cut_name": cut,
           "data_dir": str(data_dir), "split_name": split,
           "max_text_words": MAX_TEXT_WORDS,
           "max_expert_tokens": max_expert_tokens,
           "query_shuffling": "shufk1", "temporal_encoding_window": 1,
           "mix_weight": 1.0}]


def _drain(it, n):
  tic = time.perf_counter()
  got = 0
  for _ in range(n):
    got += len(next(it)["token_ids"])
  return got, time.perf_counter() - tic


def loader_rates(data_dir, cut, experts, tok, native, workers, training,
                 args):
  """(cold, warm) samples/s of one loader configuration."""
  from mmt_tpu_torch.data import native_assembler as nasm
  from mmt_tpu_torch.data import sample
  from mmt_tpu_torch.data.loader import ExpertDataLoader
  nasm.set_enabled(native)
  # A cold start: the block memo's byte budget is the process's, and the
  # records (with their memoized blocks) of earlier runs are gone.
  sample._feat_block_bytes = 0
  np.random.seed(0)
  split = SPLITS[cut][0 if training else 1]
  ldr = ExpertDataLoader(
      mix=_mix(data_dir, cut, split, args.max_expert_tokens),
      num_workers=workers, batch_size=args.batch_size,
      raw_input_dims=experts, training=training, tokenizer=tok,
      loaded_data={})
  loader = ldr["loader"]
  try:
    if training:
      it = iter(loader)
      try:
        n_videos = ldr["dataset"].datasets[0].num_train
        cold = _drain(it, math.ceil(n_videos / args.batch_size))
        _drain(it, args.warm)
        warm = _drain(it, args.batches)
      finally:
        it.close()
    else:
      cold = _drain(iter(loader), len(loader))
      passes = max(1, args.batches // len(loader))
      n = s = 0
      for _ in range(passes):
        got, sec = _drain(iter(loader), len(loader))
        n, s = n + got, s + sec
      warm = (n, s)
  finally:
    nasm.set_enabled(None)
  return cold[0] / cold[1], warm[0] / warm[1]


def text_rate(tok, texts, min_s):
  """Texts/s of ``sample.tokenize_caption`` over ``texts`` (word lists),
  repeated until ``min_s`` seconds have passed."""
  from mmt_tpu_torch.data.sample import tokenize_caption
  n, tic = 0, time.perf_counter()
  while True:
    for words in texts:
      tokenize_caption(tok, words, MAX_TEXT_WORDS)
    n += len(texts)
    sec = time.perf_counter() - tic
    if sec >= min_s:
      return n / sec


def corpus_captions(data_dir, cut):
  """Every caption of the corpus as a word list."""
  import pickle
  data_dir = pathlib.Path(data_dir)
  if cut == "c":
    with open(data_dir / "raw-captions.pkl", "rb") as f:
      table = pickle.load(f)
    return [list(c) for caps in table.values() for c in caps]
  import h5py
  out = []
  for path in sorted((data_dir.parent / "vid_feat_files").rglob("*.h5")):
    with h5py.File(path, "r") as f:
      out += [[w.decode() for w in f[k][()]] for k in f
              if k.startswith("raw_captions.")]
  return out


def host_line():
  """The host's cores, the cores this process may use, the thread pools
  of torch and numpy, and the microseconds of one
  ``np.random.RandomState(idx)``: an eval sample makes two (mix.py's
  dataset pick and make_sample's own generator)."""
  import timeit

  import torch
  try:
    from threadpoolctl import threadpool_info
    numpy_threads = sorted({p["num_threads"] for p in threadpool_info()})
  except ImportError:
    numpy_threads = "threadpoolctl absent; OMP_NUM_THREADS=" + str(
        os.environ.get("OMP_NUM_THREADS"))
  return {"cpu_count": os.cpu_count(),
          "affinity": len(os.sched_getaffinity(0)),
          "torch_threads": torch.get_num_threads(),
          "torch_interop_threads": torch.get_num_interop_threads(),
          "numpy_threads": numpy_threads,
          "random_state_us": timeit.timeit(
              lambda: np.random.RandomState(12345), number=2000) / 2e-3}


def run(args, out=print):
  """Every measurement of the protocol; returns them as a dict."""
  from mmt_tpu_torch.data import synthetic
  from mmt_tpu_torch.data.sample import tokenize_caption

  result = {"host": host_line(), "cut": args.cut, "videos": args.videos,
            "batch_size": args.batch_size}
  out(f"loader bench: host {json.dumps(result['host'])}")
  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_loader_bench_"))
  try:
    tic = time.perf_counter()
    experts = corpus_experts(args.cut)
    data_dir = synthetic.generate(
        root, num_videos=args.videos, num_test=8, experts=experts,
        captions_per_video=3, max_feats=args.max_feats, cut=args.cut)
    out(f"loader bench: corpus of {args.videos} videos (cut {args.cut}, "
        f"{len(experts)} experts, up to {args.max_feats} rows) in "
        f"{time.perf_counter() - tic:.1f} s")
    toks = tokenizers(root / "vocab.txt")
    result["loader"] = []
    for training in (True, False):
      mode = "train" if training else "eval"
      for workers in args.workers:
        runs = {"python": [], "native": []}
        for path in ORDER:
          runs[path].append(loader_rates(
              data_dir, args.cut, experts, toks[path], path == "native",
              workers, training, args))
        for path, got in runs.items():
          row = {"mode": mode, "workers": workers, "path": path,
                 "cold": float(np.mean([c for c, _ in got])),
                 "warm": float(np.mean([w for _, w in got])),
                 "runs": got}
          result["loader"].append(row)
          out(f"loader bench: {mode} workers={workers} {path}: cold "
              f"{row['cold']:.1f}, warm {row['warm']:.1f} samples/s (runs "
              + ", ".join(f"{c:.1f} / {w:.1f}" for c, w in got) + ")")
    texts = toks["native"].texts
    result["captions_native_share"] = texts["native"] / max(
        1, texts["native"] + texts["python"])
    out(f"loader bench: texts the native loaders tokenized: {texts} "
        f"(native share {result['captions_native_share']:.4f})")

    queries_dir = root / "queries"
    queries_dir.mkdir()
    (queries_dir / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + sorted(set(QUERY_WORDS))) + "\n")
    rng = np.random.RandomState(0)
    queries = [list(rng.choice(QUERY_WORDS, size=5)) for _ in range(1000)]
    result["tokenizer"] = {}
    for what, texts, vocab in (
        ("captions", corpus_captions(data_dir, args.cut), root / "vocab.txt"),
        ("queries", queries, queries_dir / "vocab.txt")):
      pair = tokenizers(vocab)
      rates = {path: text_rate(tok, texts, args.tokenizer_s)
               for path, tok in pair.items()}
      ids = {path: [tokenize_caption(tok, t, MAX_TEXT_WORDS)
                    for t in texts[:200]]
             for path, tok in pair.items()}
      if ids["python"] != ids["native"]:
        raise RuntimeError(f"loader bench: {what}: the native tokenizer's "
                           "ids differ from the Python path's")
      result["tokenizer"][what] = dict(rates, texts=len(texts))
      out(f"loader bench: tokenizer, {len(texts)} {what}: python "
          f"{rates['python']:.1f}, native {rates['native']:.1f} texts/s "
          f"({rates['native'] / rates['python']:.2f}x)")
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return result


def parse_args(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--cut", choices=("c", "jsfusion"), default="c")
  ap.add_argument("--videos", type=int, default=200)
  ap.add_argument("--max_feats", type=int, default=40,
                  help="> max_expert_tokens: forces random-pick training "
                       "assembly, the memo-proof path")
  ap.add_argument("--max_expert_tokens", type=int, default=30)
  ap.add_argument("--batch_size", type=int, default=32)
  ap.add_argument("--batches", type=int, default=20,
                  help="warm batches timed (train); eval times passes "
                       "over its split worth as many batches")
  ap.add_argument("--warm", type=int, default=10,
                  help="train batches run between the cold and the warm "
                       "timing")
  ap.add_argument("--workers", default="0,1,2,8",
                  type=lambda s: [int(x) for x in s.split(",")])
  ap.add_argument("--tokenizer_s", type=float, default=0.5,
                  help="seconds each tokenizer rate is timed at least")
  return ap.parse_args(argv)


def main(argv=None):
  result = run(parse_args(argv))
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
