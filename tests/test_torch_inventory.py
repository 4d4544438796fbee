"""Every public name of the JAX package has its place in the port.

One case per module of mmt_tpu/: its public top-level functions, classes
and constants and the public methods of its public classes, read with
``ast`` (nothing of JAX is imported).  Each must have one of

- a counterpart under the same name in the port's module at the same
  path under mmt_tpu_torch/ (a function, class, constant or method, or
  for a method an attribute a method of the class sets);
- an entry in MAPPED: the port's module and name that do its work;
- an entry in UNPORTED with its reason, one of REASONS.

The tables hold no stale entry: each names a JAX name that exists and
has no same-named counterpart, and each mapped port name exists.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "mmt_tpu", REPO / "mmt_tpu_torch"

REASONS = ("TPU workaround", "JAX-only", "waits on assets")

# (JAX module, name) -> (port module, name) that does its work.
MAPPED = {
    ("models/bert.py", "activation"): ("models/bert.py", "PLAIN_ACTIVATIONS"),
    ("models/cenet.py", "CENet.setup"): ("models/cenet.py", "CENet.__init__"),
    ("models/components.py", "DenseParams"): ("models/bert.py", "Linear"),
    ("models/components.py", "GEUParams"):
        ("models/components.py", "GatedEmbeddingUnit"),
    ("models/components.py", "ReduceDimParams"):
        ("models/components.py", "ReduceDim"),
    ("models/components.py", "TorchBatchNorm"):
        ("models/components.py", "batch_norm"),
    ("ops/__init__.py", "enable_tpu_default_kernels"):
        ("ops/__init__.py", "environment_switches"),
    ("ops/attention.py", "multi_head_attention"):
        ("ops/attention.py", "attention_bhsd"),
    ("ops/ffn.py", "use_pallas"): ("ops/__init__.py", "plain_versions"),
    ("ops/ffn.py", "pallas_active"): ("ops/__init__.py", "kernel_families"),
    ("ops/ffn.py", "xla_ffn_block"): ("ops/ffn.py", "ffn_block_ref"),
    ("ops/ffn.py", "xla_ffn_block_train"):
        ("ops/ffn.py", "ffn_train_fwd_plain"),
    ("ops/similarity.py", "use_pallas"): ("ops/__init__.py", "plain_versions"),
    ("ops/similarity.py", "pallas_active"):
        ("ops/__init__.py", "kernel_families"),
    ("ops/similarity.py", "qv_tiles"): ("ops/similarity.py", "pick_tile"),
    ("parallel/mesh.py", "barrier"): ("parallel/mesh.py", "Group.barrier"),
    ("parallel/mesh.py", "model_axis_size"): ("parallel/mesh.py", "data_mesh"),
    ("parallel/mesh.py", "param_shardings"): ("models/bert.py", "shard_dims"),
    ("parallel/mesh.py", "shard_params"): ("convert.py", "shard_state_dict"),
    ("parallel/mesh.py", "shard_batch"): ("parallel/mesh.py", "local_rows"),
    ("train/checkpoint.py", "load_checkpoint_raw"):
        ("serialization.py", "msgpack_restore"),
    ("train/optim.py", "RangerState"): ("train/optim.py", "Ranger"),
    ("train/optim.py", "ranger_factory"): ("train/optim.py", "Ranger"),
    ("train/optim.py", "ranger_lr"): ("train/optim.py", "Ranger.step"),
    ("train/optim.py", "adam"): ("train/optim.py", "_adam"),
    ("train/optim.py", "adamw"): ("train/optim.py", "_adamw"),
    ("train/optim.py", "sgd"): ("train/optim.py", "_sgd"),
    ("train/trainer.py", "Trainer.train_step"): ("train/step.py", "train_step"),
    ("train/trainer.py", "Trainer.embed_step"):
        ("train/trainer.py", "Trainer._get_embeddings"),
    ("train/trainer.py", "pad_batch_to_multiple"):
        ("parallel/mesh.py", "pad_batch_to_multiple"),
}

# (JAX module, name) -> (reason, what it does and why the port needs none).
UNPORTED = {
    ("ops/ffn.py", "kernel_fits"): (
        "TPU workaround",
        "the scoped-VMEM gate of the Pallas FFN kernel; the CUDA routes "
        "take every width (ops/ffn.py:gemm_route, f32_route)"),
    ("ops/sharding.py", "drop_conflicting_axes"): (
        "JAX-only", "a custom_partitioning sharding rule of the kernels"),
    ("ops/sharding.py", "norm_spec_entry"): (
        "JAX-only", "a custom_partitioning sharding rule of the kernels"),
    ("parallel/mesh.py", "batch_sharding"): (
        "JAX-only", "a NamedSharding for jit; each rank holds its rows"),
    ("parallel/mesh.py", "replicated"): (
        "JAX-only", "a NamedSharding for jit; replicated tensors are plain "
        "tensors on every rank"),
    ("parallel/mesh.py", "replicate_tree"): (
        "JAX-only", "host values made global arrays across processes"),
    ("train/metrics.py", "jnp_asarray"): (
        "JAX-only", "a numpy -> jax.numpy conversion"),
}


def _names(path: pathlib.Path, public: bool):
  """Top-level functions, classes and assigned names of ``path`` and
  ``Class.method`` for each method of a class; with ``public`` only those
  whose parts do not start with ``_`` (a module's ``logger`` is no API
  and is left out), else also ``Class.<name>`` for each ``self.<name>``
  a method sets (the port's counterpart of a flax property)."""
  out = set()
  for node in ast.parse(path.read_text()).body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      out.add(node.name)
    elif isinstance(node, ast.ClassDef):
      out.add(node.name)
      for sub in node.body:
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
          continue
        out.add(f"{node.name}.{sub.name}")
        if not public:
          out.update(f"{node.name}.{t.attr}" for t in ast.walk(sub)
                     if isinstance(t, ast.Attribute)
                     and isinstance(t.ctx, ast.Store)
                     and isinstance(t.value, ast.Name)
                     and t.value.id == "self")
    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
      targets = node.targets if isinstance(node, ast.Assign) else [
          node.target]
      out.update(t.id for t in targets if isinstance(t, ast.Name))
  if public:
    out = {n for n in out if n != "logger"
           and not any(part.startswith("_") for part in n.split("."))}
  return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_its_place(module):
  port_path = PORT / module
  ported = _names(port_path, False) if port_path.exists() else set()
  missing = []
  for name in sorted(_names(JAX / module, True)):
    key = (module, name)
    if name in ported:
      assert key not in MAPPED and key not in UNPORTED, (
          f"{key} is ported under its name: a stale table entry")
    elif key in MAPPED:
      port_module, port_name = MAPPED[key]
      assert port_name in _names(PORT / port_module, False), (
          f"{key} maps to {port_module}:{port_name}, which does not exist")
    elif key in UNPORTED:
      assert UNPORTED[key][0] in REASONS, key
    else:
      missing.append(name)
  assert not missing, f"{module}: no counterpart for {missing}"


def test_the_tables_name_real_jax_names():
  for module, name in (*MAPPED, *UNPORTED):
    assert name in _names(JAX / module, True), (module, name)
  assert not set(MAPPED) & set(UNPORTED)
