"""Retrieval serving CLI of the port: build an index from a trained model,
then answer text queries, once or over HTTP.

Port of scripts/serve.py, the same flags plus ``--device``:

  # one-time index build
  python -m mmt_tpu_torch.serve --config <cfg> --checkpoint <pth> \
      --build_index index.npz
  # query
  python -m mmt_tpu_torch.serve --config <cfg> --checkpoint <pth> \
      --index index.npz --query "a man cooking pasta" [--topk 5] \
      [--quantize int8]
  # HTTP daemon (GET /healthz, /statz, GET/POST /search)
  python -m mmt_tpu_torch.serve --config <cfg> --checkpoint <pth> \
      --index index.npz --listen 8080

``--checkpoint`` is a ``.pth`` in the reference's save format (a
``state_dict`` under the reference's names: one the port's trainer
wrote, or one scripts/export_checkpoint.py wrote from a JAX-trained
msgpack) or the JAX trainer's ``.msgpack`` itself.  It is loaded
strictly.  ``--index`` reads the ``.npz`` this CLI builds or the JAX
CLI's ``.msgpack`` index; ``--build_index`` writes ``.npz``.
``--device`` is a torch device and defaults to ``cuda``; without a card
pass ``--device cpu``: the port never falls back to the CPU by itself.
``--shard_index`` shards the index on the video axis over the local
cards (``parallel.local_mesh``), in this one process, as scripts/serve.py
shards it over its local chips; on one card (or the CPU) it serves
unsharded, as the JAX CLI does on one chip, and logs so.
MMT_TPU_PALLAS_FFN=0 runs the FFN blocks' plain PyTorch versions on the
card, MMT_TPU_PALLAS_SIMILARITY=0 the similarity's, as in scripts/serve.py
(``ops.environment_switches``).
"""

from __future__ import annotations

import argparse
import json
import logging

from mmt_tpu_torch import ops

logger = logging.getLogger(__name__)


def _synthesized(name: str) -> bool:
  """Keys the reference's save format carries that the port's CENet does
  not have (scripts/export_checkpoint.py synthesizes them): the unused
  BERT poolers, BatchNorm step counters and transformers' position_ids
  buffer."""
  return ("pooler" in name or "num_batches_tracked" in name
          or name.endswith("position_ids"))


def load_state_dict_strict(model, checkpoint_path) -> None:
  """Load ``checkpoint_path``'s ``state_dict`` into ``model``, refusing a
  partial fill: every parameter and buffer of the model must be in the
  file with its shape, and every key of the file the model lacks must be
  one the reference format synthesizes.  Raises ValueError naming the
  first key at fault."""
  from mmt_tpu_torch.train import checkpoint as ckpt_lib

  loaded = ckpt_lib.load_checkpoint(checkpoint_path)["state_dict"]
  target = model.state_dict()
  missing = [k for k in target if k not in loaded]
  if missing:
    raise ValueError(
        f"checkpoint {checkpoint_path} does not fill the model: "
        f"{len(missing)} entries missing (first: {missing[0]}): "
        "config/checkpoint mismatch")
  wrong = [k for k in target if tuple(loaded[k].shape) != tuple(target[k].shape)]
  if wrong:
    raise ValueError(
        f"checkpoint {checkpoint_path}: {wrong[0]} has shape "
        f"{tuple(loaded[wrong[0]].shape)}, the model "
        f"{tuple(target[wrong[0]].shape)}: config/checkpoint mismatch")
  extra = [k for k in loaded if k not in target and not _synthesized(k)]
  if extra:
    raise ValueError(
        f"checkpoint {checkpoint_path} holds {len(extra)} entries the model "
        f"has no place for (first: {extra[0]}): config/checkpoint mismatch")
  model.load_state_dict({k: loaded[k] for k in target}, strict=True)


def load_model_and_loader(config_path, checkpoint_path, device):
  """(model in eval mode, tokenizer, final_eval_sets[0]'s loader entry,
  max_text_words) for the config, the model filled from the checkpoint."""
  from mmt_tpu_torch import config as config_lib
  from mmt_tpu_torch.experts import compute_dims
  from mmt_tpu_torch.models.cenet import CENet, cenet_kwargs_from_arch_args
  from mmt_tpu_torch.registry import build
  from mmt_tpu_torch.tokenization import create_tokenizer
  import mmt_tpu_torch.data.loader  # noqa: F401 (registers ExpertDataLoader)

  cfg = config_lib.load(config_path)
  expert_dims = compute_dims(cfg.raw)
  arch_args = dict(cfg.arch_args)
  tokenizer = create_tokenizer(arch_args.get("txt_inp", "bertftn"))
  # The constructor path of training (cli.py): the text vocab is sized
  # from the tokenizer as it was when the checkpoint was written.
  model_kwargs, _ = cenet_kwargs_from_arch_args(arch_args, tokenizer)
  model = CENet(expert_dims=expert_dims, device=device, **model_kwargs)
  load_state_dict_strict(model, checkpoint_path)
  model.eval()
  entry = build("data_loader", cfg["final_eval_sets"][0],
                raw_input_dims=expert_dims, training=False,
                tokenizer=tokenizer, loaded_data={},
                cross_seed=cfg.cross_seed)
  mix0 = cfg["final_eval_sets"][0]["args"]["mix"][0]
  return model, tokenizer, entry, mix0.get("max_text_words", 30)


def main(argv=None):
  """Run the CLI; returns the answered queries as a list of
  ``{"query", "hits"}`` (each also printed as one JSON line), or None."""
  parser = argparse.ArgumentParser(description="mmt_tpu_torch retrieval "
                                               "serving")
  parser.add_argument("--config", required=True)
  parser.add_argument("--checkpoint", required=True,
                      help="model .pth (the reference's state-dict names) "
                           "or the JAX trainer's .msgpack")
  parser.add_argument("--build_index", default=None,
                      help="write the index (.npz) here and exit")
  parser.add_argument("--index", default=None,
                      help="prebuilt index path (.npz, or the JAX CLI's "
                           ".msgpack)")
  parser.add_argument("--query", action="append", default=[],
                      help="text query (repeatable)")
  parser.add_argument("--topk", type=int, default=5)
  parser.add_argument("--quantize", choices=["int8"], default=None,
                      help="serve from an int8-quantized index (4x less "
                           "index memory; approximate, see "
                           "serving.RetrievalEngine)")
  parser.add_argument("--shard_index", action="store_true",
                      help="shard the index on the video axis over the "
                           "local cards (one card, or --device cpu: "
                           "unsharded)")
  parser.add_argument("--listen", type=int, default=None, metavar="PORT",
                      help="serve a JSON HTTP API (GET/POST /search, "
                           "GET /healthz, /statz) instead of answering "
                           "--query once")
  parser.add_argument("--host", default="127.0.0.1",
                      help="bind address for --listen (default loopback)")
  parser.add_argument("--device", default="cuda",
                      help="torch device (default cuda; cpu runs the plain "
                           "PyTorch versions of the kernels)")
  args = parser.parse_args(argv)
  if not (args.index or args.build_index):
    parser.error("one of --index or --build_index is required")
  logging.basicConfig(level=logging.INFO, format="%(message)s")
  # MMT_TPU_PALLAS_FFN=0 / MMT_TPU_PALLAS_SIMILARITY=0, as scripts/serve.py.
  with ops.environment_switches():
    return _serve(args)


def _serve(args):
  from mmt_tpu_torch.parallel.mesh import local_mesh
  from mmt_tpu_torch.serving import RetrievalEngine, RetrievalIndex, serve_http
  from mmt_tpu_torch.train.trainer import check_device

  device = check_device(args.device)
  model, tokenizer, entry, max_words = load_model_and_loader(
      args.config, args.checkpoint, device)

  if args.build_index:
    dataset = entry["dataset"]
    index = RetrievalIndex.build(
        model, entry["loader"],
        dataset=dataset.datasets[0] if hasattr(dataset, "datasets")
        else dataset)
    index.save(args.build_index)
    logger.info("indexed %d videos -> %s", len(index), args.build_index)
    if not args.query and args.listen is None:
      return None

  index = RetrievalIndex.load(args.index or args.build_index)
  mesh = None
  if args.shard_index:
    mesh = local_mesh(device)
    logger.info("--shard_index: %s", f"the index over {len(mesh)} cards"
                if mesh else f"one device ({device}), the index unsharded")
  engine = RetrievalEngine(model, tokenizer, index, max_text_words=max_words,
                           mesh=mesh, quantize=args.quantize)
  if args.listen is not None:
    if args.query:
      engine.search(args.query[:1], topk=1)   # warm the query path
    serve_http(engine, host=args.host, port=args.listen)
    return None
  results = [{"query": query, "hits": hits} for query, hits in
             zip(args.query, engine.search(args.query, args.topk))]
  for result in results:
    print(json.dumps(result), flush=True)
  return results


if __name__ == "__main__":
  main()
