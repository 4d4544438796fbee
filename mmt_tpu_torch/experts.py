"""Expert (modality) registry.

The reference hardcodes the expert table inside ``compute_dims``
(utils/util.py:154-247): each expert name maps to a raw
feature dimension and a token-type index used by the video transformer's
type-embedding table.  Here the table is declarative data; ``face``-style
configurable dims are expressed as callables over the experts config.

A copy of mmt_tpu/experts.py (the port imports nothing of the JAX
package); tests hold ``compute_dims`` equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Union

DimLike = Union[int, Callable[[Mapping], int]]


@dataclasses.dataclass(frozen=True)
class ExpertSpec:
  """Static description of one expert stream."""
  name: str
  dim: DimLike          # raw feature dim (or fn of the experts config)
  idx: int              # token-type index in the video transformer
  feat_width: float | None = None  # seconds covered by one feature, None = untimed
  stride: float | None = None
  group: int | None = None

  def resolve_dim(self, experts_cfg: Mapping) -> int:
    if callable(self.dim):
      return int(self.dim(experts_cfg))
    return int(self.dim)


def _face_dim(cfg: Mapping) -> int:
  return int(cfg["face_dim"])


# ECCV20 experts (utils/util.py:160-186) with their temporal widths
# (utils/expert_timings.py:16-50).
_ECCV20 = [
    ExpertSpec("s3d", 1024, 1, feat_width=1.0),
    ExpertSpec("vggish", 128, 2, feat_width=1.0),
    ExpertSpec("face", _face_dim, 3, feat_width=None),
    ExpertSpec("audio", 128, 4, feat_width=None),
    ExpertSpec("rgb", 2048, 5, feat_width=0.2),
    ExpertSpec("speech", 300, 6, feat_width=None),
    ExpertSpec("ocr", 300, 7, feat_width=None),
    ExpertSpec("flow", 1024, 8, feat_width=None),
    ExpertSpec("scene", 2208, 9, feat_width=1.0),
]

# Challenge experts (utils/util.py:188-242).
_CHALLENGE = [
    ExpertSpec("audio_c", 128, 1, feat_width=None),
    ExpertSpec("face_c", _face_dim, 2, feat_width=None),
    ExpertSpec("i3d", 1024, 3),
    ExpertSpec("resnext101_32x48d", 2048, 4),
    ExpertSpec("senet154", 2048, 5),
    ExpertSpec("ocr_c", 300, 6, feat_width=None),
    ExpertSpec("r2p1d", 512, 7),
    ExpertSpec("s3dg", 1024, 8),
    ExpertSpec("densenet161", 2208, 9),
    ExpertSpec("speech_c", 300, 10, feat_width=None),
    ExpertSpec("r2p1dk", 512, 11),
    ExpertSpec("i3d_logits", 400, 12),
    ExpertSpec("resnext101_32x48d_logits", 1000, 13),
    ExpertSpec("senet154_logits", 1000, 14),
    ExpertSpec("r2p1d_logits", 359, 15),
    ExpertSpec("s3dg_logits", 512, 16),
    ExpertSpec("densenet161_logits", 365, 17),
    ExpertSpec("r2p1dk_logits", 400, 18),
]

EXPERT_REGISTRY: Dict[str, ExpertSpec] = {
    spec.name: spec for spec in (*_ECCV20, *_CHALLENGE)
}


def register_expert(spec: ExpertSpec) -> None:
  """Add a user-defined expert stream (mmt_tpu/experts.py:register_expert):
  ``compute_dims`` and the feature readers (``data/readers.py``) take it
  by its name from then on.  Its ``idx`` must lie inside the video
  tower's ``type_vocab_size``: ``CENet`` raises at construction
  otherwise."""
  EXPERT_REGISTRY[spec.name] = spec


def compute_dims(config: Mapping) -> Dict[str, Dict[str, int]]:
  """Expert name -> {dim, idx}, sorted by name.

  Parity with utils/util.py:154-247 (which iterates the
  sorted modality list and returns an OrderedDict).
  """
  experts_cfg = config["experts"]
  out: Dict[str, Dict[str, int]] = {}
  for name in sorted(experts_cfg["modalities"]):
    try:
      spec = EXPERT_REGISTRY[name]
    except KeyError as e:
      raise KeyError(f"unknown expert modality: {name!r}") from e
    out[name] = {"dim": spec.resolve_dim(experts_cfg), "idx": spec.idx}
  return out


def feature_timings(nb_feats: int, spec: ExpertSpec):
  """Start/end time of each feature (base/base_dataset.py:357-379 semantics).

  Returns an (nb_feats, 2) array; -1 everywhere when the expert is untimed.
  """
  import numpy as np

  if spec.feat_width is None:
    return np.full((nb_feats, 2), -1.0)
  if spec.group is not None:
    assert nb_feats % spec.group == 0
    top = feature_timings(nb_feats // spec.group,
                          ExpertSpec(spec.name, spec.dim, spec.idx,
                                     spec.feat_width, spec.stride, None))
    return np.repeat(top, spec.group, axis=-1)
  stride = spec.stride if spec.stride is not None else spec.feat_width
  starts = np.linspace(0, (nb_feats - 1) * stride, num=nb_feats)
  ends = np.linspace(spec.feat_width, (nb_feats - 1) * stride + spec.feat_width,
                     num=nb_feats)
  return np.stack((starts, ends), axis=-1)
