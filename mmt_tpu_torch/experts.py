"""Expert (modality) feature widths and token-type indices.

The ECCV20 part of mmt_tpu/experts.py's registry, copied so that the port
imports nothing of the JAX package; tests hold ``compute_dims`` equal to
the JAX package's on the flagship configuration.
"""

from __future__ import annotations

from typing import Dict, Mapping

# name -> (raw feature dim, token-type index); None = the config's face_dim.
_ECCV20 = {
    "s3d": (1024, 1), "vggish": (128, 2), "face": (None, 3),
    "audio": (128, 4), "rgb": (2048, 5), "speech": (300, 6),
    "ocr": (300, 7), "flow": (1024, 8), "scene": (2208, 9),
}


def compute_dims(config: Mapping) -> Dict[str, Dict[str, int]]:
  """Expert name -> {dim, idx}, sorted by name."""
  experts_cfg = config["experts"]
  out = {}
  for name in sorted(experts_cfg["modalities"]):
    if name not in _ECCV20:
      raise KeyError(f"unknown expert modality: {name!r}")
    dim, idx = _ECCV20[name]
    out[name] = {"dim": int(experts_cfg["face_dim"] if dim is None else dim),
                 "idx": idx}
  return out
