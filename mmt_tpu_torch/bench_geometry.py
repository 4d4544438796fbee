"""Eval and train step at the other two published geometries.

Port of scripts/bench_geometry.py.  Every number of ``bench`` is the
7-expert MSRVTT flagship's; this runs the same protocols at

- ActivityNet (configs/eccv20/activitynet_val1_trainval.json): the
  experts s3d and vggish, 100 feature rows an expert, 100 caption words,
  a video position table of 102 rows; a video sequence of 1 + 2 x (1 +
  100) = 203 tokens; eval in chunks of 25, train at b32;
- HowTo100M (howto100m_full_train.json): the same two experts, 30 rows,
  30 words, a table of 32; 63 tokens; eval in chunks of 50, train at b64.

Eval: 1,000 videos of one seeded chunk, each chunk's caption ids and
features salted (the draws of scripts/bench_geometry.py:_model_and_staged),
through ``evaluate.retrieval_eval`` (the [Q, V] matrix, merge 'indep',
then the ranks and metrics); the best of BENCH_REPS runs after a warm
one.  The JAX script adds the id salt to the token mask channel as well,
which turns the attention bias of every caption into one large constant
(1 - mask) x -10,000; here the mask stays ones.  Train: ``bench``'s step
(Adam at lr 1e-4, max-margin 0.05 with fix_norm, dropout 0.1, merge
'avg'), the mean of 20 steps chained with one synchronisation at the end,
the best of max(2, BENCH_REPS // 2) after a warm step.

  python -m mmt_tpu_torch.bench_geometry [activitynet] [howto100m]
  BENCH_VIDEOS=8 BENCH_BATCH=4 BENCH_REPS=1 \\
      python -m mmt_tpu_torch.bench_geometry --device cpu --tiny

Settings: BENCH_BATCH (the eval chunk; the geometry's), BENCH_VIDEOS
(1000), BENCH_REPS (5); the kernel switches, as ``bench`` reads them:
BENCH_PALLAS=0 runs the similarity's plain PyTorch version on the card and
BENCH_PALLAS_FFN=0 the FFN blocks', as the JAX script reads them, and
BENCH_KERNELS=0 every family's.

Prints one JSON line per geometry with the JAX script's keys but its
pallas_ffn and pallas_similarity ("routing" holds the port's choices:
whether every family's kernels ran, ``ffn.gemm_route`` at each tower's
widths, the row tile ``ffn.pick_gemm_tile`` takes at each FFN shape and
the tile ``similarity.pick_tile`` takes at each similarity shape, None
where that family runs its plain version, as on the CPU), plus
"kernel_families" ({family: whether its kernels ran}) and "card" (the
GPU's name and power limit, from nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mmt_tpu_torch import bench, evaluate, flagship, ops
from mmt_tpu_torch.ops import ffn, similarity
from mmt_tpu_torch.train.trainer import check_device

GEOMETRIES = {
    # activitynet_val1_trainval.json: experts, mix args (L = 100, pos 102).
    "activitynet": dict(modalities=["s3d", "vggish"], max_expert_tokens=100,
                        max_text_words=100, max_position_embeddings=102,
                        eval_chunk=25, train_batch=32, n_videos=1000),
    # howto100m_full_train.json (a train-only config, b64).
    "howto100m": dict(modalities=["s3d", "vggish"], max_expert_tokens=30,
                      max_text_words=30, max_position_embeddings=32,
                      eval_chunk=50, train_batch=64, n_videos=1000),
}
GEOMETRY_KEYS = ("modalities", "max_expert_tokens", "max_text_words",
                 "max_position_embeddings")
TRAIN_LR = 1e-4


def keywords(geom):
  """The JAX entry's four geometry parameters of ``geom``."""
  return {k: geom[k] for k in GEOMETRY_KEYS}


def video_tokens(geom):
  """The video transformer's sequence: CLS, then each expert's
  aggregate token and its rows."""
  return 1 + len(geom["modalities"]) * (1 + geom["max_expert_tokens"])


def salted_chunks(model, geom, chunk, n_videos, tiny):
  """scripts/bench_geometry.py:_model_and_staged's inputs, as numpy
  batches: n_videos // chunk copies of one batch of ``chunk`` (seed 0),
  copy c with its caption ids raised by a draw in [1, 1000) (mod the text
  vocabulary) and each expert's features by a draw x 0.01, from one
  RandomState(1) in the script's order."""
  batch, = bench.flagship_batches(model, 1, chunk, 0, tiny, keywords(geom))
  n_chunks = n_videos // chunk
  rng = np.random.RandomState(1)
  id_salt = rng.randint(1, 1000, size=n_chunks)
  feat_salt = {m: rng.randn(n_chunks).astype(np.float32) * 0.01
               for m in batch["features"]}
  vocab = model.txt_bert.cfg.vocab_size
  out = []
  for c in range(n_chunks):
    tokens = batch["token_ids"].copy()
    tokens[..., 0] = (tokens[..., 0] + id_salt[c]) % vocab
    out.append(dict(batch, token_ids=tokens, features={
        m: f + feat_salt[m][c] for m, f in batch["features"].items()}))
  return out


def build_eval(geom, chunk, n_videos, device="cuda", *, tiny=False):
  """The geometry's eval as ``bench_eval`` times it: (model, staged
  chunks, run() -> ``evaluate.retrieval_eval``'s result, its work
  ended)."""
  model = flagship.flagship_model(
      device=device, compute_dtype=torch.bfloat16, seed=0, tiny=tiny,
      **flagship.arch_keywords(keywords(geom)))
  staged = [flagship.batch_to_torch(b, device)
            for b in salted_chunks(model, geom, chunk, n_videos, tiny)]

  def run():
    res = evaluate.retrieval_eval(model, staged)
    bench.sync(device)
    return res

  return model, staged, run


def bench_eval(run, reps):
  """Best wall seconds of ``reps`` runs after a warm one."""
  run()
  times = []
  for _ in range(reps):
    tic = time.perf_counter()
    run()
    times.append(time.perf_counter() - tic)
  return min(times)


def routing(geom, chunk, n_videos, model, device, families):
  """The port's counterpart of the JAX script's gates: whether every
  family's kernels run (``families``: {family: whether its kernels
  run}), the FFN route at each tower's widths, and the row tile of each
  FFN shape and the block tile of each similarity shape of the geometry
  (None where the family runs its plain version)."""
  towers = {"video": (model.vid_cfg, video_tokens(geom)),
            "text": (model.txt_bert.cfg, geom["max_text_words"])}
  out = {"kernels": all(families.values()), "gemm_route": {},
         "gemm_tile_rows": {}, "sim_tile": {}}
  sms = (torch.cuda.get_device_properties(device).multi_processor_count
         if torch.device(device).type == "cuda" else None)
  for name, (cfg, tokens) in towers.items():
    h, i = cfg.hidden_size, cfg.intermediate_size
    route = ffn.gemm_route(h, i, torch.bfloat16)
    out["gemm_route"][f"{name} H {h}, I {i}"] = route
    for mode, rows in (("eval", chunk), ("train", geom["train_batch"])):
      r = rows * tokens
      out["gemm_tile_rows"][f"{mode} {name} {r} x {h}"] = (
          ffn.GEMM_TILES[ffn.pick_gemm_tile(r, h, sms)]
          if sms and families["ffn"] and route else None)
  k = len(geom["modalities"]) * model.vid_cfg.hidden_size
  for mode, n in (("eval", n_videos), ("train", geom["train_batch"])):
    out["sim_tile"][f"{mode} {n} x {n}, K {k}"] = (
        "x".join(map(str, similarity.TILES[similarity.pick_tile(n, n, sms)]))
        if sms and families["similarity"] else None)
  return out


def run_geometry(name, device, tiny, reps, card):
  """One geometry's line (a dict with the JAX script's keys), the
  families on their kernels or plain versions as they are forced now."""
  families = ops.kernel_families(device)
  geom = GEOMETRIES[name]
  chunk = int(os.environ.get("BENCH_BATCH", geom["eval_chunk"]))
  n_videos = int(os.environ.get("BENCH_VIDEOS", geom["n_videos"]))
  n_videos -= n_videos % chunk
  model, staged, run = build_eval(geom, chunk, n_videos, device, tiny=tiny)
  route = routing(geom, chunk, n_videos, model, device, families)
  eval_s = bench_eval(run, reps)
  del model, staged, run
  _, _, one = bench.train_stepper(device, tiny=tiny,
                                  batch_size=geom["train_batch"],
                                  lr=TRAIN_LR, **keywords(geom))
  train_ms = bench.chained_step_ms(one, max(2, reps // 2))
  return {
      "geometry": name,
      "modalities": geom["modalities"],
      "max_expert_tokens": geom["max_expert_tokens"],
      "eval_chunk": chunk,
      "n_videos": n_videos,
      "eval_wall_s": eval_s,
      "eval_videos_per_sec_per_chip": n_videos / eval_s,
      "train_batch": geom["train_batch"],
      "train_step_ms": train_ms,
      "train_samples_per_sec_per_chip": geom["train_batch"] * 1e3 / train_ms,
      "backend": torch.device(device).type,
      "routing": route,
      "kernel_families": families,
      "card": card,
  }


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("geometries", nargs="*", metavar="geometry",
                      help=f"of {sorted(GEOMETRIES)} (default: both)")
  parser.add_argument("--device", default="cuda",
                      help="torch device to run on (default: the card)")
  parser.add_argument("--tiny", action="store_true",
                      help="the flagship's test-width copy")
  args = parser.parse_args(argv)
  unknown = set(args.geometries) - set(GEOMETRIES)
  if unknown:
    parser.error(f"unknown geometries {sorted(unknown)}")
  device = check_device(args.device)
  reps = int(os.environ.get("BENCH_REPS", "5"))
  card = None
  if device.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_line()
  lines = []
  with bench.kernel_path(device, bench.plain_families()):
    for name in args.geometries or list(GEOMETRIES):
      lines.append(run_geometry(name, device, args.tiny, reps, card))
      print(json.dumps(lines[-1]), flush=True)
  return lines


if __name__ == "__main__":
  main()
