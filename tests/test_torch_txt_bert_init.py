"""The pretrained text-tower init in the port (mmt_tpu_torch.hf_bert,
train.checkpoint.load_txt_bert_init, Trainer._load_txt_bert_init and
``--txt_bert_init`` in mmt_tpu_torch.cli) on the CPU, against the JAX
package's (scripts/convert_hf_bert.py, its trainer's
``_load_txt_bert_init`` and train.py).

A mirror of tests/test_txt_bert_init.py at its TINY geometry: the text
tower's sequence output from one HF-style asset, port against JAX (fp32,
1e-5 absolute); the asset's formats (``pytorch_model.bin``,
``model.safetensors``, the JAX converter's msgpack) giving the same
tensors bitwise; the trainer's strict merge, under which a checkpoint
wins; the resolve priorities.  ``asset_runs`` trains both CLIs from one
asset, each through its own init path; tests/test_torch_serialization.py
holds that run (beside its other JAX CLI runs, which share the JAX
compile caches of one process).
"""

import argparse
import logging
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from mmt_tpu_torch import cli, convert, hf_bert
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.train import checkpoint as ckpt_lib
from mmt_tpu_torch.train.trainer import Trainer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_trainer import (  # noqa: E402
    CONFIG_INIT_RANGE, _epoch_losses, parity_config, write_config)
from test_train_e2e import make_config  # noqa: E402
from test_txt_bert_init import TINY, make_hf_style_state_dict  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TOWER_TOL = 1e-5


def jax_geometry(geom):
  from mmt_tpu.config import BertParams
  return BertParams(hidden_act="gelu", layer_norm_eps=1e-12, **geom)


def write_hf_dir(path, sd, fmt="bin"):
  """An HF checkpoint directory holding ``sd`` (numpy) as
  pytorch_model.bin (torch.save) or model.safetensors."""
  path.mkdir(parents=True, exist_ok=True)
  if fmt == "bin":
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               path / "pytorch_model.bin")
  else:
    from safetensors.numpy import save_file
    save_file(sd, str(path / "model.safetensors"))
  return path


def write_jax_init(sd, geom, path):
  """scripts/convert_hf_bert.py's output for ``sd``: its converter, then
  the msgpack its main writes."""
  from flax import serialization
  from scripts.convert_hf_bert import convert_hf_bert
  tree, unmapped = convert_hf_bert(sd, geometry=jax_geometry(geom))
  assert unmapped == []
  path.write_bytes(serialization.to_bytes({"params": {"txt_bert": tree}}))
  return tree


def expected_tower(sd):
  return {f"txt_bert.{k[len('bert.'):]}": torch.from_numpy(v)
          for k, v in sd.items()
          if k.startswith("bert.") and not k.startswith("bert.pooler.")}


def assert_same_tensors(got, want):
  assert sorted(got) == sorted(want)
  for name, t in want.items():
    assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


# ---------------------------------------------------------------------------
# The asset: converter, formats, the tower's forward
# ---------------------------------------------------------------------------


def test_asset_formats_give_the_same_tower(tmp_path):
  """hf_bert from a pytorch_model.bin and from a model.safetensors, and
  the JAX converter's msgpack: bitwise the same ``txt_bert.*`` tensors,
  the pooler, heads and position_ids dropped.  An HF file named as the
  init itself is refused, naming the converter."""
  sd = make_hf_style_state_dict(np.random.RandomState(3))
  sd["bert.embeddings.position_ids"] = np.arange(
      TINY["max_position_embeddings"], dtype=np.int64)[None]
  want = expected_tower(
      {k: v for k, v in sd.items() if not k.endswith("position_ids")})
  assert len(want) == 5 + 16 * TINY["num_hidden_layers"]
  outs = {}
  for fmt in ("bin", "safetensors"):
    hf_dir = write_hf_dir(tmp_path / fmt, sd, fmt)
    outs[fmt] = hf_bert.main(["--hf_dir", str(hf_dir),
                              "--out", str(tmp_path / f"{fmt}.pth")])
    assert_same_tensors(ckpt_lib.load_checkpoint(outs[fmt])["state_dict"],
                        want)
    assert_same_tensors(ckpt_lib.load_txt_bert_init(outs[fmt]), want)
  write_jax_init({k: v for k, v in sd.items()
                  if not k.endswith("position_ids")}, TINY,
                 tmp_path / "init.msgpack")
  assert_same_tensors(ckpt_lib.load_txt_bert_init(tmp_path / "init.msgpack"),
                      want)
  with pytest.raises(ValueError, match="mmt_tpu_torch.hf_bert"):
    ckpt_lib.load_txt_bert_init(tmp_path / "bin" / "pytorch_model.bin")


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int64",
                                   "empty"])
def test_safetensors_reader_is_bitwise(tmp_path, dtype):
  """hf_bert.read_safetensors against the safetensors package on F32, F16,
  BF16 and I64 tensors (an odd-sized F16 one first, so that later tensors
  start at offsets 4 and 8 do not divide) and a 0-size one; a dtype it
  does not take is refused."""
  from safetensors.torch import load_file, save_file
  gen = torch.Generator().manual_seed(0)
  odd = torch.arange(3, dtype=torch.float16)
  if dtype == "empty":
    tensors = {"a": torch.zeros((0, 3)), "b": torch.ones(2)}
  elif dtype == "int64":
    tensors = {"odd": odd,
               "a": torch.randint(-2**62, 2**62, (4, 5), generator=gen)}
  else:
    tensors = {"odd": odd,
               "a": torch.randn(4, 5, generator=gen).to(getattr(torch, dtype)),
               "b": torch.randn(7, generator=gen).to(getattr(torch, dtype))}
  path = tmp_path / "t.safetensors"
  save_file(tensors, str(path), metadata={"format": "pt"})
  got, want = hf_bert.read_safetensors(path), load_file(str(path))
  assert sorted(got) == sorted(want)
  for name, t in want.items():
    assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
    assert torch.equal(got[name].view(torch.uint8) if t.numel() else got[name],
                       t.view(torch.uint8) if t.numel() else t), name
  save_file({"x": torch.zeros(2, dtype=torch.int8)}, str(path))
  with pytest.raises(ValueError, match="dtype I8"):
    hf_bert.read_safetensors(path)


def test_tower_forward_matches_jax_from_the_same_asset(tmp_path):
  """The port's TextBert filled from hf_bert's .pth against the JAX
  TextBert from convert_hf_bert's tree of the same HF state dict:
  sequence output, fp32, 1e-5 absolute."""
  from mmt_tpu.models.bert import TextBert as JaxTextBert
  from mmt_tpu_torch.config import BertParams
  from mmt_tpu_torch.models.bert import TextBert

  rng = np.random.RandomState(0)
  sd = make_hf_style_state_dict(rng)
  pth = hf_bert.main(["--hf_dir", str(write_hf_dir(tmp_path / "hf", sd)),
                      "--out", str(tmp_path / "init.pth")])
  tree = write_jax_init(sd, TINY, tmp_path / "init.msgpack")

  b, s = 2, 9
  ids = rng.randint(0, TINY["vocab_size"], (b, s)).astype(np.int32)
  mask = np.ones((b, s), np.int32)
  mask[1, 6:] = 0
  types = np.zeros((b, s), np.int32)
  pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
  want = np.asarray(JaxTextBert(jax_geometry(TINY)).apply(
      {"params": tree}, ids, mask, types, pos, deterministic=True))

  tower = TextBert(BertParams(hidden_act="gelu", layer_norm_eps=1e-12,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **TINY),
                   compute_dtype=torch.float32, device="cpu")
  init = ckpt_lib.load_txt_bert_init(pth)
  tower.load_state_dict({k[len("txt_bert."):]: v for k, v in init.items()},
                        strict=True)
  long = lambda a: torch.from_numpy(a.astype(np.int64))
  with torch.no_grad():
    got = tower(long(ids), long(mask), long(types), long(pos)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=TOWER_TOL)


# ---------------------------------------------------------------------------
# The trainer's init
# ---------------------------------------------------------------------------


def make_workspace(root):
  """A synthetic corpus under ``root`` and one HF-style asset at TINY
  geometry with its vocab: (root, data_dir, vocab size, hf_bert's .pth);
  the JAX converter's msgpack of the same asset is
  root/txt_bert_init.msgpack."""
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
  from mmt_tpu_torch.tokenization import WordPieceTokenizer
  vocab = WordPieceTokenizer(root / "vocab.txt").vocab_size
  geom = dict(TINY, vocab_size=vocab)
  sd = make_hf_style_state_dict(np.random.RandomState(1), geom=geom)
  pth = hf_bert.main(["--hf_dir", str(write_hf_dir(root / "hf", sd)),
                      "--out", str(root / "txt_bert_init.pth")])
  write_jax_init(sd, geom, root / "txt_bert_init.msgpack")
  return root, data_dir, vocab, pathlib.Path(pth)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
  return make_workspace(tmp_path_factory.mktemp("torch_txt_bert_init"))


def tiny_config(workspace, name, epochs=2):
  root, data_dir, vocab, _ = workspace
  cfg = make_config(root, data_dir, root / "exps" / name)
  cfg["arch"]["args"]["text_bert_geometry"]["vocab_size"] = vocab
  cfg["trainer"]["epochs"] = epochs
  return write_config(root, name, cfg)


def tower_params(trainer):
  return {f"txt_bert.{n}": p.detach().clone()
          for n, p in trainer.model.txt_bert.named_parameters()}


def test_trainer_loads_init_and_checkpoint_wins(workspace):
  """--txt_bert_init lands in the model's text tower bitwise (trained
  from it for an epoch, and evaluated from it); a warm-start checkpoint
  loaded over a zero init wins."""
  root, _, _, pth = workspace
  init = ckpt_lib.load_txt_bert_init(pth)
  cli.main(["--config", str(tiny_config(workspace, "init", epochs=1)),
            "--device", "cpu", "--txt_bert_init", str(pth)])
  ckpt = root / "exps" / "init" / "trained_model.pth"
  assert ckpt.exists()
  assert np.isfinite(_epoch_losses(root / "exps" / "init")).all()

  ev = cli.main(["--config", str(tiny_config(workspace, "evalonly")),
                 "--device", "cpu", "--only_eval", "--txt_bert_init", str(pth)])
  assert_same_tensors(tower_params(ev), init)

  zero = root / "zero_init.pth"
  torch.save({"state_dict": {k: torch.zeros_like(v) for k, v in init.items()}},
             zero)
  wm = cli.main(["--config", str(tiny_config(workspace, "warm")),
                 "--device", "cpu", "--only_eval", "--load_checkpoint",
                 str(ckpt), "--txt_bert_init", str(zero)])
  saved = ckpt_lib.load_checkpoint(ckpt)["state_dict"]
  got = tower_params(wm)
  assert_same_tensors(got, {k: saved[k] for k in got})
  assert all(t.abs().sum() > 0 for t in got.values())


class _Holder:
  """The part of a Trainer that ``_load_txt_bert_init`` reads."""

  def __init__(self, model):
    self.model = model


def _tower_model(hidden=48, vocab=100):
  model = torch.nn.Module()
  model.txt_bert = torch.nn.Module()
  model.txt_bert.ln = torch.nn.LayerNorm(hidden)
  model.txt_bert.word = torch.nn.Embedding(vocab, hidden)
  return model


def test_no_match_raises(tmp_path):
  """A nothing-matched init (wrong geometry) is an error, not a no-op."""
  bad = tmp_path / "bad.pth"
  torch.save({"state_dict": {"txt_bert.ln.weight": torch.ones(16),
                             "txt_bert.ln.bias": torch.zeros(16)}}, bad)
  with pytest.raises(ValueError, match="no leaf matched"):
    Trainer._load_txt_bert_init(_Holder(_tower_model()), str(bad))


def test_partial_match_raises(tmp_path):
  """An asset that fills the LayerNorm but not the custom-vocab word table
  raises, naming the first leaf it could not fill; nothing is copied."""
  model = _tower_model()
  before = model.txt_bert.ln.weight.detach().clone()
  asset = tmp_path / "partial.pth"
  torch.save({"state_dict": {
      "txt_bert.ln.weight": torch.full((48,), 2.0),
      "txt_bert.ln.bias": torch.zeros(48),
      "txt_bert.word.weight": torch.zeros(28996, 48)}}, asset)
  with pytest.raises(ValueError, match="could not be initialized.*"
                     "txt_bert.word.weight"):
    Trainer._load_txt_bert_init(_Holder(model), str(asset))
  assert torch.equal(model.txt_bert.ln.weight, before)


def test_init_fills_parameters_only_and_logs_the_count(tmp_path, caplog):
  """The merge fills every txt_bert parameter and logs matched/total; a
  model without a text tower warns and ignores the init."""
  model = _tower_model()
  model.txt_bert.register_buffer("steps", torch.tensor(7))
  asset = tmp_path / "init.pth"
  want = {"txt_bert.ln.weight": torch.full((48,), 2.0),
          "txt_bert.ln.bias": torch.full((48,), 0.5),
          "txt_bert.word.weight": torch.ones(100, 48),
          "txt_bert.steps": torch.tensor(0)}
  torch.save({"state_dict": want}, asset)
  with caplog.at_level(logging.INFO):
    Trainer._load_txt_bert_init(_Holder(model), str(asset))
  assert "txt_bert init: 3/3 leaves loaded" in caplog.text
  got = {f"txt_bert.{k}": v for k, v in model.txt_bert.state_dict().items()}
  assert int(got.pop("txt_bert.steps")) == 7
  assert_same_tensors(got, {k: v for k, v in want.items() if "steps" not in k})
  caplog.clear()
  with caplog.at_level(logging.WARNING):
    Trainer._load_txt_bert_init(_Holder(torch.nn.Linear(2, 2)), str(asset))
  assert "no txt_bert tower; ignored" in caplog.text


# ---------------------------------------------------------------------------
# Resolving the init (train.py's order)
# ---------------------------------------------------------------------------


class _Cfg:
  resume = None
  txt_bert_init = None


def test_resolve_priorities(tmp_path, monkeypatch):
  """CLI --txt_bert_init > MMT_TPU_TXT_BERT_INIT > arch.args > the port's
  default .pth > the JAX converter's default .msgpack; a custom geometry
  blocks the defaults; bertscr and the non-bert towers never auto-load."""
  files = {n: tmp_path / f"{n}.bin" for n in
           ("cli", "env", "arch", "pth", "msgpack")}
  for f in files.values():
    f.write_bytes(b"x")
  monkeypatch.setattr(cli, "TXT_BERT_INIT_DEFAULTS",
                      (str(files["pth"]), str(files["msgpack"])))
  monkeypatch.delenv("MMT_TPU_TXT_BERT_INIT", raising=False)
  resolve = cli.resolve_txt_bert_init

  cfg = _Cfg()
  assert resolve(cfg, None, "bertftn") == str(files["pth"])
  files["pth"].unlink()
  assert resolve(cfg, None, "bertftn") == str(files["msgpack"])
  files["msgpack"].unlink()
  assert resolve(cfg, None, "bertftn") is None
  files["pth"].write_bytes(b"x")
  assert resolve(cfg, None, "bertfrz") == str(files["pth"])
  assert resolve(cfg, None, "bertftn", custom_geometry=True) is None
  assert resolve(cfg, None, "bertscr") is None
  assert resolve(cfg, None, "vlad") is None
  assert resolve(cfg, str(files["arch"]), "bertftn") == str(files["arch"])
  monkeypatch.setenv("MMT_TPU_TXT_BERT_INIT", str(files["env"]))
  assert resolve(cfg, str(files["arch"]), "bertftn") == str(files["env"])
  cfg.txt_bert_init = str(files["cli"])
  assert resolve(cfg, str(files["arch"]), "bertftn") == str(files["cli"])
  assert resolve(cfg, None, "bertftn", custom_geometry=True) == str(
      files["cli"])
  cfg.txt_bert_init = str(tmp_path / "absent.pth")
  with pytest.raises(FileNotFoundError):
    resolve(cfg, None, "bertftn")


def test_cli_flag_reaches_the_resolver(tmp_path, capsys):
  """--txt_bert_init is a flag of the port's CLI, as of train.py's, and
  the config from_args builds carries it to the resolver."""
  import train as jax_cli
  from mmt_tpu_torch import config as config_lib

  for module in (cli, jax_cli):
    with pytest.raises(SystemExit):
      module.main(["--help"])
    assert "--txt_bert_init" in capsys.readouterr().out
  cfg_path = tmp_path / "c.json"
  cfg_path.write_text('{"trainer": {"save_dir": "%s"}}' % (tmp_path / "x"))
  (tmp_path / "init.pth").write_bytes(b"x")
  config = config_lib.from_args(argparse.Namespace(
      config=str(cfg_path), resume=None, load_checkpoint=None,
      only_eval=False, txt_bert_init=str(tmp_path / "init.pth")))
  assert cli.resolve_txt_bert_init(config, None, "bertftn") == str(
      tmp_path / "init.pth")


def test_non_pretrained_towers_reject_or_ignore_init(tmp_path, monkeypatch,
                                                     caplog):
  """bertscr / vlad towers stay random: a CLI or config init is a
  contradiction (raise), an ambient environment variable is ignored."""
  f = tmp_path / "init.pth"
  f.write_bytes(b"x")
  monkeypatch.setenv("MMT_TPU_TXT_BERT_INIT", str(f))
  with caplog.at_level(logging.INFO):
    assert cli.resolve_txt_bert_init(_Cfg(), None, "bertscr") is None
    assert cli.resolve_txt_bert_init(_Cfg(), None, "vlad") is None
  assert "MMT_TPU_TXT_BERT_INIT ignored" in caplog.text
  monkeypatch.delenv("MMT_TPU_TXT_BERT_INIT")
  cfg = _Cfg()
  cfg.txt_bert_init = str(f)
  with pytest.raises(ValueError, match="conflicts with txt_agg"):
    cli.resolve_txt_bert_init(cfg, None, "bertscr")
  with pytest.raises(ValueError, match="conflicts with txt_agg"):
    cli.resolve_txt_bert_init(_Cfg(), str(f), "mxp")


# ---------------------------------------------------------------------------
# Both CLIs from the same asset (held in tests/test_torch_serialization.py)
# ---------------------------------------------------------------------------


def asset_runs(workspace, exps):
  """2 epochs of the parity config at the config's initializer_range
  (0.02) by the JAX CLI with --txt_bert_init <convert_hf_bert's msgpack>
  and by the port's CLI with --txt_bert_init <hf_bert's .pth>, every
  other weight from the JAX trainer's init (the port's warm start carries
  no txt_bert entry, so its tower comes from its own init path).  Returns
  (JAX trainer, port trainer, the JAX trainer's whole initial state
  dict)."""
  import jax
  import train as jax_cli
  from mmt_tpu import config as jax_config

  root, data_dir, vocab, pth = workspace
  cfgs = {}
  for name in ("jax", "port"):
    cfg = parity_config(root, data_dir, exps / name, CONFIG_INIT_RANGE)
    cfg["arch"]["args"]["text_bert_geometry"]["vocab_size"] = vocab
    cfgs[name] = write_config(exps, name, cfg)
  ns = argparse.Namespace(config=str(cfgs["jax"]), resume=None,
                          load_checkpoint=None, only_eval=False,
                          txt_bert_init=str(root / "txt_bert_init.msgpack"))
  jax_trainer = jax_cli.build_trainer(jax_config.from_args(ns))
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  init = convert.state_dict_from_flax(to_np(jax_trainer.params),
                                      to_np(jax_trainer.batch_stats))
  torch.save({"state_dict": {k: v for k, v in init.items()
                             if not k.startswith("txt_bert.")}},
             exps / "init.pth")
  jax_trainer.train()
  jax_trainer.evaluate()
  port = cli.main(["--config", str(cfgs["port"]), "--device", "cpu",
                   "--load_checkpoint", str(exps / "init.pth"),
                   "--txt_bert_init", str(pth)])
  return jax_trainer, port, init
