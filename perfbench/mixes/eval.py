"""The retrieval-eval program: ``mmt_tpu_torch.evaluate.retrieval_eval``
over a test corpus staged on the device in the eval loader's chunks
(a ragged last chunk where the corpus does not divide), both towers, the
[Q, V] similarity, the ranks both ways and the metrics; one whole eval
after another.

Traffic parameters: ``videos`` (the corpus), ``chunk`` (videos a batch)
and ``captions_per_video``.
"""

from __future__ import annotations

import time

import torch

from mmt_tpu_torch import evaluate
from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.train import metrics as metrics_lib
from perfbench import checks, flops, inputs, port
from perfbench.reference import model as ref_model
from perfbench.reference import retrieval as ref_retrieval

KIND = "eval"


def chunk_sizes(traffic):
  n, c = traffic["videos"], traffic["chunk"]
  return [c] * (n // c) + ([n % c] if n % c else [])


def unit_flops(cell):
  t = cell.traffic
  return flops.eval_flops(cell.cfg, t["videos"], t["captions_per_video"])


def ffn_calls(cell):
  return flops.ffn_calls_eval(cell.cfg, chunk_sizes(cell.traffic),
                              cell.traffic["captions_per_video"])


class State:

  def __init__(self, cell):
    cfg, t, dev = cell.cfg, cell.traffic, cell.device
    self.cell = cell
    weights = inputs.make_weights(cfg, cell.seed, dev)
    self.model = port.build_model(cfg, weights, dev).train(False)
    del weights
    self.batches = inputs.make_batches(cfg, chunk_sizes(t), cell.seed, dev,
                                       t["captions_per_video"])
    self.outputs, self.last = [], None
    self.model.register_forward_hook(
        lambda mod, args, out: self.outputs.append(out))
    self.warm_up()

  def warm_up(self):
    """Every shape an eval runs, once, without a whole eval: the towers
    over a whole chunk and the ragged last one, then the similarity and
    the ranks both ways at the corpus's size, over those chunks'
    embeddings tiled to it."""
    sizes = chunk_sizes(self.cell.traffic)
    chunks = self.batches[:1] + (self.batches[-1:] if sizes[-1] != sizes[0]
                                 else [])
    emb = evaluate.embed_corpus(self.model, chunks)
    videos = self.cell.traffic["videos"]
    caps = emb["query_masks"].shape[1]

    def tile(x, rows):
      reps = -(-rows // len(x))
      return x.repeat((reps,) + (1,) * (x.dim() - 1))[:rows]

    with torch.inference_mode():
      sims = similarity_ops.moe_similarity(
          tile(emb["text_embds"], videos * caps),
          tile(emb["vid_embds"], videos),
          tile(emb["text_weights"], videos * caps),
          tile(emb["vid_weights"], videos), merge="indep", num_caps=caps)
      masks = tile(emb["query_masks"], videos).cpu().numpy()
      metrics_lib.t2v_metrics(sims, masks)
      metrics_lib.v2t_metrics(sims, masks)
    self.outputs = []

  def eval(self):
    """One whole retrieval eval; keeps its tower outputs (the chunks'
    forward outputs, by reference) and its result."""
    self.outputs = []
    self.last = evaluate.retrieval_eval(self.model, self.batches)


def setup(cell):
  return State(cell)


def window(state, seconds, sync):
  """Whole evals until ``seconds`` of host time have passed (each ends in
  its metrics' host reads), then a synchronise: {"units", "seconds"}."""
  sync()
  n, t0 = 0, time.perf_counter()
  while True:
    state.eval()
    n += 1
    if time.perf_counter() - t0 >= seconds:
      break
  sync()
  return {"units": n, "seconds": time.perf_counter() - t0}


def end_to_end(cell, win):
  return {"eval_videos_per_s": (win["units"] * cell.traffic["videos"]
                                / win["seconds"], "videos/s")}


def slice_work(state):
  return state.eval, 1


def _flat(outs):
  cat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
  b, k, m, d = cat["text_embds"].shape
  cat["text_embds"] = cat["text_embds"].reshape(b * k, m, d)
  cat["text_weights"] = cat["text_weights"].reshape(b * k, m)
  return cat


def results(state):
  """The last eval's outputs, similarity and metrics, on the host; frees
  the program's state."""
  res = state.last
  out = {"outputs": checks.to_host(_flat(state.outputs)),
         "sims": res["sims"].float().cpu(),
         "t2v_metrics": res["t2v_metrics"], "v2t_metrics": res["v2t_metrics"]}
  del state.model, state.batches, state.outputs, state.last
  return out


def reference(cell, tf32=False, transform=None):
  """The reference's outputs and similarity over the same corpus, from
  the seed; with ``tf32`` (the control) or a ``transform`` of each batch
  (a fault) also its ranks and metrics, so it can stand in the
  program's place."""
  t, dev = cell.traffic, cell.device
  weights = inputs.make_weights(cell.cfg, cell.seed, dev)
  batches = inputs.make_batches(cell.cfg, chunk_sizes(t), cell.seed, dev,
                                t["captions_per_video"])
  batches = [transform(b) for b in batches] if transform else batches
  with ref_model.precision(tf32):
    emb = ref_retrieval.embed(weights, cell.cfg, batches)
    sims = ref_retrieval.sims(emb)
  out = {"outputs": checks.to_host(emb), "sims": sims.float().cpu()}
  if tf32 or transform:
    for key, ranks in (("t2v_metrics", ref_retrieval.t2v_ranks(out["sims"])),
                       ("v2t_metrics", ref_retrieval.v2t_ranks(out["sims"]))):
      out[key] = dict(ref_retrieval.metrics(ranks),
                      cols=[int(r) for r in ranks])
  return out


def numbers(prog, ref):
  return checks.eval_numbers(prog, ref)
