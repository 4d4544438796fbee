"""Explicit component registries.

Replaces the reference's reflective ``ConfigParser.init(name, module)``
factory (parse_config.py:138-145) with named registries so
that every constructible component is discoverable and typo-checked.

A copy of mmt_tpu/registry.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRIES: Dict[str, Dict[str, Callable[..., Any]]] = {}


def register(kind: str, name: str):
  """Decorator: register a constructor under (kind, name)."""
  def deco(fn):
    _REGISTRIES.setdefault(kind, {})[name] = fn
    return fn
  return deco


def get(kind: str, name: str) -> Callable[..., Any]:
  try:
    return _REGISTRIES[kind][name]
  except KeyError as e:
    known = sorted(_REGISTRIES.get(kind, {}))
    raise KeyError(f"unknown {kind} {name!r}; registered: {known}") from e


def build(kind: str, spec: Dict[str, Any], **extra):
  """Instantiate a {'type': ..., 'args': {...}} config entry."""
  args = dict(spec.get("args", {}))
  overlap = set(args) & set(extra)
  assert not overlap, f"Overwriting config args is not allowed: {overlap}"
  args.update(extra)
  return get(kind, spec["type"])(**args)


def available(kind: str):
  return sorted(_REGISTRIES.get(kind, {}))
