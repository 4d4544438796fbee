"""Serving latency percentiles through the real HTTP server.

Port of scripts/bench_serving.py.  A client of ``serving.serve_http``
measures what a caller sees (HTTP parse, the handler's lock, the
tokenizer, the text tower, the similarity against the index, the top-k,
the JSON reply): client-side percentiles, and the server's own /statz
reservoir.

Model: the full-width flagship (bf16, random weights from seed 0;
``--tiny``: its test-width copy).  Index: BENCH_INDEX synthetic videos x 7
experts x the model's width (512), L2-normalised rows and L1-normalised
weights drawn on the device from seed 0 (serving time depends on the
shapes, not the values).  Queries: 5 words of WORDS each, over a
WordPiece vocabulary of those words.  For the exact (fp32) engine, then
the int8 one: a server on an ephemeral port, warmed with 3 GETs and 3
POSTs, then BENCH_REQS interactive GETs (1 query, topk 5) and
BENCH_BULK_REQS bulk POSTs (64 queries, topk 10); /statz must count
exactly those requests.

  python -m mmt_tpu_torch.bench_serving
  BENCH_INDEX=300 BENCH_REQS=4 BENCH_BULK_REQS=2 \\
      python -m mmt_tpu_torch.bench_serving --device cpu --tiny

Prints a line per engine and, last, one JSON line with the JAX script's
keys (``index``, ``params_m``, then ``fp32`` and ``int8``, each with
``batch1_ms`` and ``batch64_ms`` percentiles, ``batch64_qps`` and
``server_statz``) plus "card" (the GPU's name and power limit, from
nvidia-smi).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import pathlib
import shutil
import tempfile
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

N_VIDEOS = int(os.environ.get("BENCH_INDEX", "100000"))
N_INTERACTIVE = int(os.environ.get("BENCH_REQS", "200"))
N_BULK = int(os.environ.get("BENCH_BULK_REQS", "50"))
N_EXPERTS = 7
WORDS = ("person cooking pasta kitchen soccer match goal rain city "
         "night dog park guitar song stage car road mountain beach").split()
INTERACTIVE = (1, 5)   # queries a request, topk: GET
BULK = (64, 10)        # the same: POST
WARM_REQS = 3


def synthetic_index(n, m, d, device, seed=0):
  """A ``serving.RetrievalIndex`` of n videos x m experts x d: unit-norm
  rows and weights that sum to 1, drawn on ``device`` from ``seed``."""
  from mmt_tpu_torch.serving import RetrievalIndex
  gen = torch.Generator(device=device).manual_seed(seed)
  emb = torch.randn(n, m, d, generator=gen, device=device)
  emb /= emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
  w = torch.rand(n, m, generator=gen, device=device)
  w /= w.sum(-1, keepdim=True)
  return RetrievalIndex(emb.cpu().numpy(), w.cpu().numpy(),
                        [f"video{i:07d}" for i in range(n)], [""] * n)


def vocab_tokenizer(root, words=WORDS):
  """A WordPiece tokenizer over ``words`` (its vocab written to
  ``root``)."""
  from mmt_tpu_torch.tokenization import WordPieceTokenizer
  vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(words))
  path = pathlib.Path(root) / "vocab.txt"
  path.write_text("\n".join(vocab) + "\n")
  return WordPieceTokenizer(str(path))


def queries(rng, n, words=WORDS):
  return [" ".join(rng.choice(words, size=5)) for _ in range(n)]


def http_json(url, payload=None):
  """(reply, seconds) of one GET, or one POST of ``payload``."""
  tic = time.perf_counter()
  req = url if payload is None else urllib.request.Request(
      url, data=json.dumps(payload).encode(),
      headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as r:
    body = json.loads(r.read())
  return body, time.perf_counter() - tic


def pct_ms(xs, p):
  """The p-th percentile of seconds ``xs``, in ms (the server's rule)."""
  xs = sorted(xs)
  return 1e3 * xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def percentiles(xs):
  return {"p50": pct_ms(xs, 50), "p90": pct_ms(xs, 90),
          "p99": pct_ms(xs, 99), "max": pct_ms(xs, 100)}


def search(base, qs, topk):
  """(reply, seconds) of one search: a GET for one query, else a POST."""
  if len(qs) == 1:
    return http_json(f"{base}/search?q={urllib.parse.quote(qs[0])}"
                     f"&topk={topk}")
  return http_json(f"{base}/search", {"queries": qs, "topk": topk})


@contextlib.contextmanager
def quiet_server_log():
  """No access-log line a request, whatever logging the process set up
  (scripts/bench_serving.py measured a server that logged none)."""
  from mmt_tpu_torch import serving
  log = logging.getLogger(serving.__name__)
  level = log.level
  log.setLevel(logging.WARNING)
  try:
    yield
  finally:
    log.setLevel(level)


def measure(engine, rng, n_interactive, n_bulk, check=None):
  """The protocol on one engine: a fresh ``serve_http`` on port 0,
  warmed, then the interactive GETs and the bulk POSTs.  ``check(reply,
  n_queries, topk)`` sees every timed reply.  Raises unless /statz counts
  exactly the timed requests and queries and no error.  Returns the
  engine's entry of the summary."""
  from mmt_tpu_torch import serving
  with quiet_server_log():
    server = serving.serve_http(engine, host="127.0.0.1", port=0,
                                block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
      for _ in range(WARM_REQS):
        for batch, topk in (INTERACTIVE, BULK):
          search(base, queries(rng, batch), topk)
      before = http_json(f"{base}/statz")[0]
      lat = {}
      for (batch, topk), n in ((INTERACTIVE, n_interactive), (BULK, n_bulk)):
        lat[batch] = []
        for _ in range(n):
          body, dt = search(base, queries(rng, batch), topk)
          if check is not None:
            check(body, batch, topk)
          lat[batch].append(dt)
      statz = http_json(f"{base}/statz")[0]
    finally:
      server.shutdown()
      server.server_close()
  counted = {k: statz[k] - before[k] for k in ("requests", "errors",
                                               "queries")}
  want = {"requests": n_interactive + n_bulk, "errors": 0,
          "queries": n_interactive * INTERACTIVE[0] + n_bulk * BULK[0]}
  if counted != want:
    raise RuntimeError(f"/statz counted {counted}, expected {want}")
  b1, b64 = lat[INTERACTIVE[0]], lat[BULK[0]]
  return {"batch1_ms": percentiles(b1), "batch64_ms": percentiles(b64),
          "batch64_qps": BULK[0] / sorted(b64)[len(b64) // 2],
          "server_statz": statz.get("search_latency_ms")}


def run(device, tiny=False, out=print):
  """The whole protocol; returns the summary."""
  from mmt_tpu_torch import bench, flagship
  from mmt_tpu_torch.serving import RetrievalEngine
  from mmt_tpu_torch.train.trainer import check_device

  device = check_device(device)
  card = None
  if device.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_line()
  model = flagship.flagship_model(device=device, seed=0, tiny=tiny)
  n_params = sum(t.numel() for t in model.state_dict().values())
  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_bench_serving_"))
  try:
    tok = vocab_tokenizer(root)
    index = synthetic_index(N_VIDEOS, N_EXPERTS, model.same_dim, device)
    out(f"model {n_params / 1e6:.1f}M params, index {N_VIDEOS} videos")
    rng = np.random.RandomState(7)
    summary = {"index": N_VIDEOS, "params_m": n_params / 1e6}
    for quant in (None, "int8"):
      label = quant or "fp32"
      tic = time.perf_counter()
      engine = RetrievalEngine(model, tok, index, quantize=quant)
      summary[label] = measure(engine, rng, N_INTERACTIVE, N_BULK)
      out(f"[{label}] {json.dumps(summary[label])} "
          f"({time.perf_counter() - tic:.1f} s)")
      del engine
    summary["card"] = card
    return summary
  finally:
    shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda",
                      help="torch device to run on (default: the card)")
  parser.add_argument("--tiny", action="store_true",
                      help="the flagship's test-width copy")
  args = parser.parse_args(argv)
  summary = run(args.device, args.tiny,
                out=lambda line: print(line, flush=True))
  print(json.dumps(summary))
  return summary


if __name__ == "__main__":
  main()
