"""Pretrained HuggingFace BERT weights -> the port's text-tower init.

Port of scripts/convert_hf_bert.py:

  python -m mmt_tpu_torch.hf_bert --hf_dir /path/to/bert-base-cased \\
      [--out data/txt_bert_init.pth]

reads a local HF checkpoint (``pytorch_model.bin``, else
``model.safetensors``, read by this module's own reader of that format)
and writes ``{"state_dict": {"txt_bert.*": tensor}}``, the port's
checkpoint layout.  ``python -m mmt_tpu_torch.train`` loads the default
output for every bertftn / bertfrz run (``cli.resolve_txt_bert_init``),
``--txt_bert_init`` points it elsewhere, and the file also works through
``--load_checkpoint``.  The port's text tower carries HF's names, so only
the ``bert.`` prefix goes; the pooler, the ``cls.*`` heads and the
``position_ids`` buffer are dropped, and floating tensors are stored as
float32, the parameters' dtype.  Unlike the JAX converter, which fills a
freshly drawn tower, the output holds the checkpoint's tensors only: the
trainer's strict merge names any tower entry it lacks.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import struct

import torch

logger = logging.getLogger(__name__)

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "txt_bert_init.pth")

# safetensors dtype names -> torch dtypes.
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path):
  """A ``.safetensors`` file -> {name: tensor}: an 8-byte little-endian
  header length, a JSON header of {name: {dtype, shape, data_offsets}},
  then the tensors' little-endian bytes.  The file is read once."""
  size = os.path.getsize(path)
  data = bytearray(size)
  with open(path, "rb") as f:
    f.readinto(data)
  (n,) = struct.unpack("<Q", data[:8])
  header = json.loads(data[8:8 + n])
  body = memoryview(data)[8 + n:]
  out = {}
  for name, info in header.items():
    if name == "__metadata__":
      continue
    if info["dtype"] not in _ST_DTYPES:
      raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which "
                       f"this reader does not take ({sorted(_ST_DTYPES)})")
    dtype, shape = _ST_DTYPES[info["dtype"]], tuple(info["shape"])
    begin, end = info["data_offsets"]
    if begin == end:
      out[name] = torch.empty(shape, dtype=dtype)
    else:
      out[name] = torch.frombuffer(body[begin:end], dtype=dtype).reshape(
          shape).clone()
  return out


def load_hf_state_dict(hf_dir):
  """A local HF BERT checkpoint (``pytorch_model.bin`` or
  ``model.safetensors`` in ``hf_dir``) -> {HF name: tensor}."""
  bin_path = os.path.join(hf_dir, "pytorch_model.bin")
  st_path = os.path.join(hf_dir, "model.safetensors")
  if os.path.exists(bin_path):
    return torch.load(bin_path, map_location="cpu", weights_only=True)
  if os.path.exists(st_path):
    return read_safetensors(st_path)
  raise FileNotFoundError(
      f"no pytorch_model.bin/model.safetensors in {hf_dir}")


def hf_to_cenet_names(state_dict):
  """HF names ('bert.encoder...' or 'encoder...') -> 'txt_bert...', the
  MLM / NSP heads ('cls.*'), the pooler and position_ids dropped (the
  retrieval model uses the sequence output only)."""
  out = {}
  for key, val in state_dict.items():
    name = key[len("bert."):] if key.startswith("bert.") else key
    if (name.startswith(("cls.", "pooler."))
        or name.endswith("position_ids")):
      continue
    out[f"txt_bert.{name}"] = (val.float() if val.is_floating_point()
                               else val)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(
      description="convert a local HF BERT checkpoint to the port's "
                  "text-tower init")
  parser.add_argument("--hf_dir", required=True)
  parser.add_argument("--out", default=DEFAULT_OUT,
                      help="output .pth (default: the location the port's "
                           "trainer loads, data/txt_bert_init.pth)")
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO, format="%(message)s")

  state_dict = hf_to_cenet_names(load_hf_state_dict(args.hf_dir))
  out = os.path.abspath(args.out)
  os.makedirs(os.path.dirname(out), exist_ok=True)
  torch.save({"state_dict": state_dict}, out)
  logger.info("wrote %d tensors (%s parameters) to %s", len(state_dict),
              f"{sum(t.numel() for t in state_dict.values()):,}", out)
  return out


if __name__ == "__main__":
  main()
