"""Retrieval serving: a precomputed video index and a text-query engine.

Port of mmt_tpu/serving.py for one card.  Embed a corpus once into an
index (per-modality embeddings and MoE weights), then answer free-text
queries with one text-tower forward, the MoE similarity against the
index (two fp32 ``torch.mm``s: the JAX engine scores outside its kernel,
mmt_tpu/serving.py:307-315) and a top-k on the device:

  index = RetrievalIndex.build(model, loader)      # or .load(path)
  engine = RetrievalEngine(model, tokenizer, index)
  hits = engine.search(["a man cooking pasta"], topk=5)

The index is saved with ``numpy.savez``; ``RetrievalIndex.load`` also
reads the flax msgpack the JAX package writes (serialization.py).
``quantize="int8"`` serves from a per-row int8 copy of the index; its
product is the library's int8 GEMM (``torch._int_mm``) on the card, as
it was a plain XLA dot_general in the JAX package.

``mesh=`` (a sequence of torch devices, ``parallel.local_mesh``) shards
the index on the video axis over those devices, as the JAX engine shards
it over a 1-D data mesh of its local chips: one process addresses every
shard.  The rows are zero-padded to a multiple of the shard count and
split evenly; a query batch runs the text tower once, on the model's
device, then each shard's product ([Q, V / n]) and top-k on its device,
and one more top-k merges them on the model's device.  Pad rows score
-inf and never reach a result.
"""

from __future__ import annotations

import collections
import collections.abc
import dataclasses
import http.server
import json
import logging
import threading
import time
import urllib.parse
from typing import Dict, List, Sequence

import numpy as np
import torch

from mmt_tpu_torch.data import loader as loader_lib
from mmt_tpu_torch.data.sample import crop_or_pad_tokens, tokenize_caption
from mmt_tpu_torch.ops import similarity as similarity_ops

logger = logging.getLogger(__name__)

# torch._int_mm on the card takes more than 16 rows in A and a depth and a
# width that are multiples of 8: query rows are zero-padded up to
# INT8_MIN_ROWS, index rows to a multiple of INT8_ROW_MULTIPLE.
INT8_MIN_ROWS, INT8_ROW_MULTIPLE = 32, 8


def _quantize_rows_int8(flat: np.ndarray):
  """Symmetric per-row int8 quantization: ``flat ~= scale[:, None] * q8``.

  One fp32 scale per row (= per video) over the weight-scaled flattened
  [N, M*D] index; all-zero rows get scale 1 so they stay exactly zero.
  """
  scale = np.abs(flat).max(axis=1) / 127.0
  scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
  q8 = np.clip(np.rint(flat / scale[:, None]), -127, 127).astype(np.int8)
  return q8, scale


def _int8_dots(a, b):
  """int32 [Q, N] = a [Q, K] . b [N, K]^T for int8 operands: the
  library's int8 GEMM on the card (A zero-padded to INT8_MIN_ROWS rows;
  K and N must be multiples of 8), an int32 product on the CPU."""
  if not a.is_cuda:
    return a.to(torch.int32) @ b.to(torch.int32).T
  q = a.shape[0]
  if q < INT8_MIN_ROWS:
    a = torch.cat([a, a.new_zeros((INT8_MIN_ROWS - q, a.shape[1]))])
  return torch._int_mm(a, b.T)[:q]


def _int8_moe_similarity(text_embds, text_weights,
                         vid_q8, vid_scale, vid_weights):
  """MoE similarity against a row-quantized int8 index.

  The math of ops/similarity.py with the index's weight-scaled flattened
  rows stored int8 plus one fp32 scale per video.  The queries are
  quantized the same way (``torch.round``, half to even, as ``np.rint``
  for the index), the [Q, M*D] x [M*D, V] product runs int8 x int8 ->
  int32, and the result is rescaled by the two row scales.  The MoE
  denominator stays exact fp32 ([Q, M] x [M, V]), with the zero guard.
  """
  q, m, d = text_embds.shape
  tw = text_weights.float()
  tf = (text_embds.float() * tw[:, :, None]).reshape(q, m * d)
  ts = tf.abs().amax(1) / 127.0
  ts = torch.where(ts == 0, torch.ones_like(ts), ts)
  tq8 = torch.clamp(torch.round(tf / ts[:, None]), -127, 127).to(torch.int8)
  dots = _int8_dots(tq8, vid_q8)
  numer = dots.float() * ts[:, None] * vid_scale[None, :]
  denom = tw @ vid_weights.float().T
  denom = torch.where(denom == 0,
                      torch.full_like(denom, similarity_ops.EPS_ZERO_GUARD),
                      denom)
  return numer / denom


def stage_index(vid_embds, vid_weights, device, quantize=None):
  """The device tensors a query batch is scored against.

  Exact: the weight-scaled, flattened fp32 rows [V, M*D] (the pre-scaling
  of ops/similarity.py:moe_similarity, done once) and the weights [V, M].
  int8: the rows quantized per row (``_quantize_rows_int8``), their
  scales and the weights, each padded with rows of zero codes, unit
  scale and zero weights to a multiple of INT8_ROW_MULTIPLE rows (the
  int8 GEMM's width; ``index_similarity`` masks them out).
  """
  embds = np.asarray(vid_embds, np.float32)
  weights = np.asarray(vid_weights, np.float32)
  n, m, d = embds.shape
  if quantize == "int8":
    q8, scale = _quantize_rows_int8(
        (embds * weights[:, :, None]).reshape(n, m * d))
    pad = (-n) % INT8_ROW_MULTIPLE
    return (torch.from_numpy(np.pad(q8, ((0, pad), (0, 0)))).to(device),
            torch.from_numpy(np.pad(scale, (0, pad), constant_values=1.0))
            .to(device),
            torch.from_numpy(np.pad(weights, ((0, pad), (0, 0)))).to(device))
  w = torch.from_numpy(weights).to(device, copy=True)
  v = torch.from_numpy(embds).to(device) * w[:, :, None]
  return v.reshape(n, m * d), w


def index_similarity(text_embds, text_weights, staged, n_real,
                     quantize=None):
  """fp32 [Q, staged rows] MoE similarity of text_embds [Q, M, D] and
  text_weights [Q, M] against ``stage_index``'s tensors: exact, the
  library route of ops/similarity.py (``library_similarity``, what
  ``moe_similarity(prefer_kernel=False)`` takes: two fp32 ``torch.mm``s,
  as mmt_tpu/serving.py scores with ``prefer_pallas=False`` and never
  enters the kernel), or the int8 product with the columns from
  ``n_real`` on (padding) at -inf."""
  if quantize == "int8":
    sims = _int8_moe_similarity(text_embds, text_weights, *staged)
    sims[:, n_real:] = float("-inf")
    return sims
  v, vw = staged
  q, m, d = text_embds.shape
  tw = text_weights.float().contiguous()
  t = (text_embds.float() * tw[:, :, None]).reshape(q, m * d)
  return similarity_ops.library_similarity(t, v, tw, vw)


@dataclasses.dataclass
class RetrievalIndex:
  """Embedded corpus: [N, M, D] video embeddings + [N, M] MoE weights."""
  vid_embds: np.ndarray
  vid_weights: np.ndarray
  video_ids: List[str]
  paths: List[str]

  @classmethod
  def build(cls, model, loader, dataset=None) -> "RetrievalIndex":
    """Embed every video served by ``loader`` (an eval BatchLoader) on
    the model's device, through the loader's prefetch."""
    device = next(model.parameters()).device
    embds, weights, paths = [], [], []
    with torch.inference_mode():
      for batch in loader_lib.device_prefetch(iter(loader), device):
        out = model.embed_video(batch)
        embds.append(out["vid_embds"])
        weights.append(out["vid_weights"])
        paths.extend(batch.get("paths", []))
      vid_embds = torch.cat(embds, 0).cpu().numpy()
      vid_weights = torch.cat(weights, 0).cpu().numpy()
    if dataset is not None and hasattr(dataset, "vid_list"):
      video_ids = list(dataset.vid_list)[:len(vid_embds)]
    else:
      video_ids = [f"video{i}" for i in range(len(vid_embds))]
    return cls(vid_embds, vid_weights, video_ids,
               paths or [""] * len(vid_embds))

  def extend(self, other: "RetrievalIndex") -> "RetrievalIndex":
    """Append another index's videos in place (incremental corpus growth).

    Geometry must match (same modality count and embedding width) and
    ids must stay unique; both are checked before anything mutates.
    Engines serving this index pick the rows up through
    :meth:`RetrievalEngine.refresh`.
    """
    if other.vid_embds.shape[1:] != self.vid_embds.shape[1:]:
      raise ValueError(
          f"index geometry mismatch: existing rows are "
          f"{self.vid_embds.shape[1:]}, new rows are "
          f"{other.vid_embds.shape[1:]} (different model/config?)")
    dup = set(self.video_ids) & set(other.video_ids)
    if dup:
      raise ValueError(f"duplicate video_ids: {sorted(dup)[:5]}"
                       f"{'...' if len(dup) > 5 else ''}")
    self.vid_embds = np.concatenate([self.vid_embds, other.vid_embds], 0)
    self.vid_weights = np.concatenate(
        [self.vid_weights, other.vid_weights], 0)
    self.video_ids = list(self.video_ids) + list(other.video_ids)
    self.paths = list(self.paths) + list(other.paths)
    return self

  def remove(self, ids) -> "RetrievalIndex":
    """Drop videos by id in place.  Unknown ids raise KeyError (a typo'd
    removal must not silently leave stale content in a served index)."""
    drop = set(ids)
    unknown = drop - set(self.video_ids)
    if unknown:
      raise KeyError(f"video_ids not in index: {sorted(unknown)[:5]}"
                     f"{'...' if len(unknown) > 5 else ''}")
    keep = np.array([v not in drop for v in self.video_ids], bool)
    self.vid_embds = self.vid_embds[keep]
    self.vid_weights = self.vid_weights[keep]
    self.video_ids = [v for v, k in zip(self.video_ids, keep) if k]
    self.paths = [p for p, k in zip(self.paths, keep) if k]
    return self

  def save(self, path) -> None:
    """Write the index to ``path`` as an ``.npz`` archive (written to the
    path as given: no suffix is added)."""
    # ids/paths are stored newline-joined; an embedded "\n" would split
    # into phantom entries on load and desynchronize ids from embeddings.
    for name, vals in (("video_ids", self.video_ids), ("paths", self.paths)):
      bad = next((v for v in vals if "\n" in str(v)), None)
      if bad is not None:
        raise ValueError(f"{name} entry contains a newline and would break "
                         f"the index round-trip: {bad!r}")
    with open(path, "wb") as f:
      np.savez(f, vid_embds=self.vid_embds, vid_weights=self.vid_weights,
               video_ids=np.array("\n".join(self.video_ids)),
               paths=np.array("\n".join(str(p) for p in self.paths)))

  @classmethod
  def load(cls, path) -> "RetrievalIndex":
    """An index ``save`` wrote (``.npz``), or one the JAX package's
    ``RetrievalIndex.save`` wrote (``.msgpack``, the same four fields)."""
    if str(path).endswith(".msgpack"):
      from mmt_tpu_torch import serialization
      raw = serialization.msgpack_restore(path)
      vid_embds = np.asarray(raw["vid_embds"])
      vid_weights = np.asarray(raw["vid_weights"])
      video_ids, paths = raw["video_ids"], raw["paths"]
    else:
      with np.load(path, allow_pickle=False) as raw:
        vid_embds = raw["vid_embds"]
        vid_weights = raw["vid_weights"]
        video_ids, paths = str(raw["video_ids"]), str(raw["paths"])
    # "".split("\n") == [""], so an EMPTIED index (remove() can legally
    # drain it) would round-trip into one phantom "" id desynchronized
    # from the 0 embedding rows; condition the parse on the row count.
    n = len(vid_embds)
    video_ids = video_ids.split("\n") if n else []
    paths = paths.split("\n") if n else []
    if len(video_ids) != n or len(paths) != n:
      raise ValueError(
          f"corrupt index at {path}: {n} embedding rows but "
          f"{len(video_ids)} video_ids / {len(paths)} paths")
    return cls(vid_embds, vid_weights, video_ids, paths)

  def __len__(self):
    return len(self.vid_embds)


class RetrievalEngine:
  """Free-text video search over a RetrievalIndex, on the model's device.

  The exact engine stages the index's weight-scaled, flattened fp32 rows
  [V, M*D] and weights [V, M] on the device once and scores each query
  batch against them with ``index_similarity``.  With ``quantize="int8"``
  the index is staged as per-row symmetric int8 (+ one fp32 scale per
  video): 4x less device memory and index traffic, an approximation
  chosen per engine, so exact and quantized engines can serve side by
  side from one index.
  With ``mesh`` (a sequence of torch devices; repeats allowed, so shards
  may share one card) the index is sharded over them on the video axis
  (the module docstring); either quantization composes with it.
  """

  def __init__(self, model, tokenizer, index: RetrievalIndex,
               max_text_words: int = 30, mesh=None, quantize=None):
    if quantize not in (None, "int8"):
      raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if mesh is not None:
      if (not isinstance(mesh, collections.abc.Sequence)
          or isinstance(mesh, str) or not mesh
          or not all(isinstance(d, (torch.device, str, int)) for d in mesh)):
        raise TypeError(f"mesh must be a non-empty sequence of torch "
                        f"devices, got {mesh!r}")
      mesh = [torch.device(d) for d in mesh]
    self.mesh = mesh
    self.model = model
    self.tokenizer = tokenizer
    self.index = index
    self.max_text_words = max_text_words
    self.quantize = quantize
    self.device = next(model.parameters()).device
    # search() and refresh() serialize on this lock, and search maps
    # top-k rows through the id/path SNAPSHOT taken when the device
    # tensors were staged, never through the live (mutable) index: a
    # search always sees one consistent (tensors, ids) pair, even while
    # another thread mutates the index in place and calls refresh().
    self._lock = threading.RLock()
    self._stage_index(index)

  def refresh(self, index: RetrievalIndex = None) -> None:
    """Pick up index mutations (RetrievalIndex.extend/remove, or a whole
    new index) without rebuilding the engine: re-quantizes and re-stages
    the device tensors; no video is embedded again."""
    with self._lock:
      if index is not None:
        self.index = index
      self._stage_index(self.index)

  def _stage_index(self, index: RetrievalIndex) -> None:
    """Stage every shard: the rows zero-padded to a multiple of the shard
    count (mmt_tpu/serving.py:272-285) and split evenly, each slice
    staged on its device by ``stage_index``; with its real row count."""
    devices = self.mesh or [self.device]
    embds, weights = index.vid_embds, index.vid_weights
    n = len(embds)
    per = -(-n // len(devices))
    pad = per * len(devices) - n
    if pad:
      embds = np.concatenate([embds, np.zeros((pad,) + embds.shape[1:],
                                              embds.dtype)], 0)
      weights = np.concatenate([weights, np.zeros((pad,) + weights.shape[1:],
                                                  weights.dtype)], 0)
    # Stage first: if it raises (out of device memory), the engine keeps
    # serving its previous tensors with their own ids.
    shards = [(dev, stage_index(embds[i * per:(i + 1) * per],
                                weights[i * per:(i + 1) * per], dev,
                                self.quantize),
               min(max(n - i * per, 0), per))
              for i, dev in enumerate(devices)]
    self._staged_ids = tuple(index.video_ids)
    self._staged_paths = tuple(index.paths)
    self._shards, self._shard_rows = shards, per

  def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
    rows = []
    for text in texts:
      ids = tokenize_caption(self.tokenizer, text.split(),
                             self.max_text_words)
      rows.append(crop_or_pad_tokens(ids, self.max_text_words))
    return np.stack(rows, 0)[:, None].astype(np.int32)   # [B, 1, T, 2]

  @property
  def num_videos(self) -> int:
    """Size of the corpus actually being served (the staged snapshot:
    the live index may differ between a mutation and refresh())."""
    return len(self._staged_ids)

  def _shard_similarities(self, texts: Sequence[str]):
    """fp32 [len(texts), staged rows] scores of every query against each
    shard, on the shard's device, pad columns -inf: the text tower runs
    once, on the model's device, and every shard's product is issued
    before anything waits.  Call under the lock."""
    token_ids = torch.from_numpy(self.encode_queries(texts)).to(self.device)
    out = self.model.embed_text(token_ids)
    b, c, m, d = out["text_embds"].shape
    t = out["text_embds"].reshape(b * c, m, d)
    tw = out["text_weights"].reshape(b * c, m)
    sims = []
    for dev, staged, n_real in self._shards:
      s = index_similarity(t.to(dev), tw.to(dev), staged, n_real,
                           self.quantize)
      if n_real < s.shape[1]:
        s[:, n_real:] = float("-inf")
      sims.append(s)
    return sims

  def _similarities(self, texts: Sequence[str]):
    """The shards' scores side by side on the model's device (checks)."""
    return torch.cat([s.to(self.device)
                      for s in self._shard_similarities(texts)], 1)

  def search(self, texts: Sequence[str], topk: int = 5) -> List[List[Dict]]:
    with self._lock, torch.inference_mode():
      return self._search_locked(texts, topk)

  def _top(self, texts: Sequence[str], k: int):
    """(scores, staged row indices) [Q, k] on the model's device: one
    top-k, or under a mesh a top-k per shard (at most its rows) merged by
    one more."""
    sims = self._shard_similarities(texts)
    if len(sims) == 1:
      return torch.topk(sims[0], k)
    parts = [torch.topk(s, min(k, self._shard_rows)) for s in sims]
    scores = torch.cat([v.to(self.device) for v, _ in parts], 1)
    rows = torch.cat([i.to(self.device) + n * self._shard_rows
                      for n, (_, i) in enumerate(parts)], 1)
    scores, pick = torch.topk(scores, k)
    return scores, rows.gather(1, pick)

  def _search_locked(self, texts: Sequence[str], topk: int) -> List[List[Dict]]:
    n_staged = len(self._staged_ids)
    if int(topk) <= 0 or n_staged == 0:
      return [[] for _ in texts]   # "no results" probe, not "at least one"
    k = min(int(topk), n_staged)
    scores, idx = self._top(texts, k)
    # One device-to-host copy of scores and indices together.
    packed = torch.stack([scores.view(torch.int32),
                          idx.to(torch.int32)]).cpu()
    scores = packed[0].view(torch.float32).tolist()
    idx = packed[1].tolist()
    return [[{"video_id": self._staged_ids[v],
              "path": self._staged_paths[v],
              "score": s, "rank": rank}
             for rank, (v, s) in enumerate(zip(idx[q], scores[q]))]
            for q in range(len(texts))]


# ---------------------------------------------------------------------------
# HTTP serving: a dependency-free JSON endpoint over RetrievalEngine:
#
#   GET  /healthz                          -> {"ok": true, "videos": N}
#   GET  /statz                            -> counters + latency percentiles
#   GET  /search?q=<text>[&q=...][&topk=K] -> {"results": [[hit, ...], ...]}
#   POST /search  {"queries": [...], "topk": K}  (same response shape)
#
# Handler threads serialize on one lock around the query: the card runs
# one query batch at a time, so concurrency buys batching at the client,
# not here; send several q= terms / queries entries per request to batch.
# ---------------------------------------------------------------------------


class _ServerStats:
  """Per-server request counters + a bounded search-latency reservoir.

  Feeds the /statz endpoint: p50/p90/p99 search latency as measured AT
  the server (device work included), error and request counts.  The
  reservoir keeps the most recent ``maxlen`` samples: a long-lived server
  reports current behavior, not a lifetime average.
  """

  def __init__(self, maxlen: int = 4096):
    self._lock = threading.Lock()
    self._lat = collections.deque(maxlen=maxlen)
    self.requests = 0
    self.errors = 0
    self.queries = 0
    self.started = time.time()

  def record(self, latency_s: float, n_queries: int) -> None:
    with self._lock:
      self._lat.append(latency_s)
      self.requests += 1
      self.queries += n_queries

  def record_error(self) -> None:
    with self._lock:
      self.errors += 1

  def snapshot(self) -> Dict:
    with self._lock:
      lat = sorted(self._lat)
      out = {"requests": self.requests, "errors": self.errors,
             "queries": self.queries,
             "uptime_s": round(time.time() - self.started, 1)}
    if lat:
      def pct(p):
        return round(1e3 * lat[min(len(lat) - 1,
                                   int(p / 100 * len(lat)))], 2)
      out["search_latency_ms"] = {
          "count": len(lat), "mean": round(1e3 * sum(lat) / len(lat), 2),
          "p50": pct(50), "p90": pct(90), "p99": pct(99),
          "max": round(1e3 * lat[-1], 2)}
    return out


class _RetrievalHandler(http.server.BaseHTTPRequestHandler):
  engine: "RetrievalEngine" = None  # type: ignore[assignment]
  lock: threading.Lock = None       # type: ignore[assignment]
  stats: _ServerStats = None        # type: ignore[assignment]
  max_queries = 256

  def _reply(self, code: int, payload: Dict) -> None:
    blob = json.dumps(payload).encode("utf-8")
    self.send_response(code)
    self.send_header("Content-Type", "application/json")
    self.send_header("Content-Length", str(len(blob)))
    self.end_headers()
    self.wfile.write(blob)

  def _search(self, queries: List[str], topk: int) -> None:
    if not queries:
      self._reply(400, {"error": "no queries given"})
      return
    if len(queries) > self.max_queries:
      self._reply(400, {"error": f"max {self.max_queries} queries/request"})
      return
    if not all(isinstance(q, str) and q.strip() for q in queries):
      self._reply(400, {"error": "queries must be non-empty strings"})
      return
    # topk <= 0 means "no results" (the engine's contract); the clamp
    # only caps at the index size, it must not floor at 1.
    topk = max(0, min(int(topk), self.engine.num_videos))
    t0 = time.perf_counter()
    try:
      with self.lock:
        results = self.engine.search(queries, topk=topk)
    except Exception:
      if self.stats is not None:
        self.stats.record_error()
      raise
    if self.stats is not None:
      self.stats.record(time.perf_counter() - t0, len(queries))
    self._reply(200, {"results": results})

  def do_GET(self):  # noqa: N802 (stdlib API name)
    url = urllib.parse.urlparse(self.path)
    if url.path == "/healthz":
      self._reply(200, {"ok": True, "videos": self.engine.num_videos})
      return
    if url.path == "/statz":
      stats = self.stats.snapshot() if self.stats is not None else {}
      self._reply(200, {"videos": self.engine.num_videos, **stats})
      return
    if url.path == "/search":
      qs = urllib.parse.parse_qs(url.query)
      try:
        topk = int(qs.get("topk", ["5"])[0])
      except ValueError:
        self._reply(400, {"error": "topk must be an integer"})
        return
      self._search(qs.get("q", []), topk)
      return
    self._reply(404, {"error": f"unknown path {url.path!r}"})

  def do_POST(self):  # noqa: N802
    url = urllib.parse.urlparse(self.path)
    if url.path != "/search":
      self._reply(404, {"error": f"unknown path {url.path!r}"})
      return
    try:
      length = int(self.headers.get("Content-Length", "0"))
      body = json.loads(self.rfile.read(length) or b"{}")
      queries = body.get("queries", [])
      topk = int(body.get("topk", 5))
    except (ValueError, json.JSONDecodeError) as exc:
      self._reply(400, {"error": f"bad request body: {exc}"})
      return
    if not isinstance(queries, list):
      self._reply(400, {"error": "'queries' must be a list of strings"})
      return
    self._search(queries, topk)

  def log_message(self, fmt, *args):  # route to logging, not stderr
    logger.info("%s - %s", self.address_string(), fmt % args)


def serve_http(engine: RetrievalEngine, host: str = "127.0.0.1",
               port: int = 8080, block: bool = True):
  """Serve ``engine`` over HTTP.  ``block=False`` starts a daemon thread
  and returns the ``ThreadingHTTPServer`` (call ``.shutdown()`` and
  ``.server_close()`` to stop it); the bound port is
  ``server.server_address[1]`` (pass ``port=0`` for an ephemeral one)."""
  handler = type("BoundHandler", (_RetrievalHandler,),
                 {"engine": engine, "lock": threading.Lock(),
                  "stats": _ServerStats()})
  server = http.server.ThreadingHTTPServer((host, port), handler)
  server.stats = handler.stats  # introspection (scripts, tests)
  logger.info("serving retrieval API on http://%s:%d (index: %d videos)",
              server.server_address[0], server.server_address[1],
              len(engine.index))
  if not block:
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
  # Graceful SIGTERM (the preemption signal on managed fleets): finish
  # in-flight requests, then return.  shutdown() must run off the
  # serve_forever thread, hence the helper thread.
  import signal

  def _sigterm(signum, frame):
    logger.info("SIGTERM: shutting down retrieval API")
    threading.Thread(target=server.shutdown, daemon=True).start()

  prev = None
  try:
    prev = signal.signal(signal.SIGTERM, _sigterm)
  except ValueError:
    pass  # not on the main thread; rely on KeyboardInterrupt/.shutdown()
  try:
    server.serve_forever()
  except KeyboardInterrupt:
    pass
  finally:
    if prev is not None:
      signal.signal(signal.SIGTERM, prev)
    server.server_close()
  return server
