"""The port's data side (mmt_tpu_torch.data, tokenization, config,
experts, registry, utils) against the JAX package's on the CPU.

The synthetic corpora, the tokenizer ids and the first train batches and
every eval batch of an ExpertDataLoader must be equal, array for array,
with ``num_workers=0`` (workers draw from the global numpy RNG in no
fixed order, in both packages).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from mmt_tpu import config as jax_config
from mmt_tpu import experts as jax_experts
from mmt_tpu import tokenization as jax_tok
from mmt_tpu.data import loader as jax_loader
from mmt_tpu.data import synthetic as jax_synthetic
from mmt_tpu_torch import config as port_config
from mmt_tpu_torch import experts as port_experts
from mmt_tpu_torch import tokenization as port_tok
from mmt_tpu_torch.data import loader as port_loader
from mmt_tpu_torch.data import synthetic as port_synthetic
from mmt_tpu_torch.utils import checks

REPO = pathlib.Path(__file__).resolve().parent.parent
EXPERTS = {"rgb": 2048, "s3d": 1024}
CUTS = ("jsfusion", "c")
# (train split, eval split) of each cut's split engine
SPLITS = {"jsfusion": ("trainval", "test"), "c": ("trainval", "val")}


def _generate(module, root, cut):
  return module.generate(root, num_videos=14, num_test=6, experts=EXPERTS,
                         captions_per_video=3, cut=cut)


@pytest.fixture(scope="module", params=CUTS)
def corpora(request, tmp_path_factory):
  """The same corpus written by each package: (cut, jax dir, port dir)."""
  cut = request.param
  roots = {}
  for name, module in (("jax", jax_synthetic), ("port", port_synthetic)):
    roots[name] = tmp_path_factory.mktemp(f"{name}_{cut}")
    _generate(module, roots[name], cut)
  return cut, roots["jax"], roots["port"]


def _files(root):
  return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                if p.is_file())


def _h5_arrays(path):
  with h5py.File(path, "r") as f:
    return {k: f[k][()] for k in f.keys()}


def assert_tree_equal(a, b, path=""):
  if isinstance(a, dict):
    assert sorted(a) == sorted(b), path
    for k in a:
      assert_tree_equal(a[k], b[k], f"{path}/{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      assert_tree_equal(x, y, f"{path}[{i}]")
  elif isinstance(a, np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), path
  else:
    assert a == b, path


def test_synthetic_corpus_equals_the_jax_one(corpora):
  cut, jax_root, port_root = corpora
  jax_files, port_files = _files(jax_root), _files(port_root)
  if cut == "c":
    # The pickle layout reads no h5; the port writes none (no h5py needed).
    jax_files = [f for f in jax_files if not f.endswith(".h5")]
  assert jax_files == port_files
  for rel in port_files:
    a, b = jax_root / rel, port_root / rel
    if rel.endswith(".h5"):
      assert_tree_equal(_h5_arrays(a), _h5_arrays(b), rel)
    elif rel.endswith((".pkl", ".pickle")):
      with open(a, "rb") as fa, open(b, "rb") as fb:
        assert_tree_equal(pickle.load(fa), pickle.load(fb), rel)
    else:
      assert a.read_bytes() == b.read_bytes(), rel


def _sentences():
  rng = np.random.RandomState(3)
  words = (jax_synthetic.TOPICS + jax_synthetic.FILLER
           + ["Café", "naïve", "über", "don't", "e-mail", "中文", "Ωmega",
              "[CLS]", "x[SEP]y", "surfing!", "paintings"])
  return [" ".join(rng.choice(words, rng.randint(1, 14)))
          for _ in range(200)]


@pytest.mark.parametrize("vocab", ("synthetic", "large"))
def test_tokenizer_ids_equal_the_jax_tokenizer(tmp_path, vocab):
  path = tmp_path / "vocab.txt"
  if vocab == "synthetic":
    jax_synthetic.write_vocab(path)
    assert port_synthetic.write_vocab(tmp_path / "v2.txt").read_bytes() == (
        path.read_bytes())
  else:
    jax_synthetic.write_large_vocab(path)
    assert port_synthetic.write_large_vocab(
        tmp_path / "v2.txt").read_bytes() == path.read_bytes()
  jt = jax_tok.WordPieceTokenizer(path)
  pt = port_tok.WordPieceTokenizer(path)
  assert pt.vocab_size == jt.vocab_size
  for text in _sentences():
    assert pt.tokenize(text) == jt.tokenize(text), text
    assert pt.encode(text, max_len=12) == jt.encode(text, max_len=12), text


def test_create_tokenizer_refuses_the_word_embedding_tokenizer(tmp_path,
                                                             monkeypatch):
  """bert* builds WordPiece; wo2v* / grvl* build the word-embedding
  tokenizer from MMT_TPU_WORD_VECTORS and refuse to start without it."""
  jax_synthetic.write_vocab(tmp_path / "vocab.txt")
  tok = port_tok.create_tokenizer("bertftn", tmp_path / "vocab.txt")
  assert isinstance(tok, port_tok.WordPieceTokenizer)
  monkeypatch.delenv("MMT_TPU_WORD_VECTORS", raising=False)
  for kind in ("wo2vftn", "grvlfrz"):
    with pytest.raises(ValueError, match="MMT_TPU_WORD_VECTORS"):
      port_tok.create_tokenizer(kind)
  (tmp_path / "vectors.txt").write_text("a 1 2\nb 3 4\n")
  monkeypatch.setenv("MMT_TPU_WORD_VECTORS", str(tmp_path / "vectors.txt"))
  tok = port_tok.create_tokenizer("grvlfrz")
  assert isinstance(tok, port_tok.WeTokenizer) and tok.freeze
  assert tok.vocab_size == 4 and tok.text_dim == 2


def _mix(data_dir, cut, split, training):
  entry = {"dataset_name": "MSRVTT", "cut_name": cut,
           "data_dir": str(data_dir), "split_name": split,
           "max_text_words": 12, "max_expert_tokens": 4,
           "query_shuffling": "shufk1" if training else "indiv"}
  if not training:
    entry["captions_per_video"] = 2
  return [entry]


def _batches(module, tok_module, root, cut, training, n=None):
  """Batches of one package's ExpertDataLoader after seeding numpy as the
  trainer does (train: the first ``n`` shuffled batches)."""
  np.random.seed(0)
  tok = tok_module.WordPieceTokenizer(root / "vocab.txt")
  split = SPLITS[cut][0 if training else 1]
  dims = {m: {"dim": d, "idx": i} for i, (m, d) in enumerate(EXPERTS.items())}
  loader = module.ExpertDataLoader(
      mix=_mix(root / "MSRVTT", cut, split, training), num_workers=0,
      batch_size=4, raw_input_dims=dims, training=training, tokenizer=tok,
      loaded_data={})
  it = iter(loader["loader"])
  return [next(it) for _ in range(n)] if n else list(it)


@pytest.mark.parametrize("training", (True, False), ids=("train", "eval"))
def test_loader_batches_equal_the_jax_loader(corpora, training):
  cut, jax_root, port_root = corpora
  n = 4 if training else None
  want = _batches(jax_loader, jax_tok, jax_root, cut, training, n)
  got = _batches(port_loader, port_tok, port_root, cut, training, n)
  assert len(got) == len(want) and len(got) >= (4 if training else 2)
  for b_got, b_want in zip(got, want):
    # paths name the corpus directory, which differs
    b_got = {k: v for k, v in b_got.items() if k != "paths"}
    b_want = {k: v for k, v in b_want.items() if k != "paths"}
    assert_tree_equal(b_got, b_want)


def test_device_prefetch_on_the_cpu_only_converts():
  batches = [{"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "f": {"rgb": np.ones((2, 4), np.int32)},
              "raw_captions": [["x"], ["y"]]} for _ in range(3)]
  out = list(port_loader.device_prefetch(iter(batches), "cpu"))
  assert len(out) == 3
  for got, want in zip(out, batches):
    assert isinstance(got["a"], torch.Tensor) and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], torch.from_numpy(want["a"]))
    assert got["f"]["rgb"].dtype == torch.int32
    assert got["raw_captions"] is want["raw_captions"]


def test_device_prefetch_on_cuda_raises_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the CUDA prefetch runs in chip_smoke.py")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    next(port_loader.device_prefetch(iter([{"a": np.zeros(2)}]), "cuda"))


def test_validate_batch_names_each_broken_invariant(corpora):
  cut, _, port_root = corpora
  batch = _batches(port_loader, port_tok, port_root, cut, False)[0]
  checks.validate_batch(batch)
  bad = dict(batch, token_ids=batch["token_ids"].copy())
  bad["token_ids"][0, 0, 0, 0] = -1
  with pytest.raises(ValueError, match="negative token ids"):
    checks.validate_batch(bad)
  feats = {m: f.copy() for m, f in batch["features"].items()}
  mod = next(iter(feats))
  feats[mod][0, 0, 0] = np.nan
  with pytest.raises(ValueError, match="non-finite"):
    checks.validate_batch(dict(batch, features=feats))


def test_compute_dims_equals_the_jax_registry():
  names = sorted(jax_experts.EXPERT_REGISTRY)
  assert sorted(port_experts.EXPERT_REGISTRY) == names
  cfg = {"experts": {"face_dim": 384, "modalities": names}}
  assert port_experts.compute_dims(cfg) == jax_experts.compute_dims(cfg)
  for name in ("rgb", "face", "i3d"):
    spec = port_experts.EXPERT_REGISTRY[name]
    jspec = jax_experts.EXPERT_REGISTRY[name]
    np.testing.assert_array_equal(port_experts.feature_timings(7, spec),
                                  jax_experts.feature_timings(7, jspec))


@pytest.mark.parametrize("text", ("bertftn", "bertfrz4", "bertftnmxp",
                                  "bertscr", "vlad", "lstm"))
def test_txt_agg_spec_equals_the_jax_parse(text):
  assert (port_config.TxtAggSpec.parse(text).__dict__
          == jax_config.TxtAggSpec.parse(text).__dict__)


@pytest.mark.parametrize("monitor", ("off", "given_epoch 7", "max epoch",
                                     "min MSRVTT_jsfusion_test/t2v_metrics/MedR"))
def test_parse_monitor_equals_the_jax_parse(monitor):
  assert port_config.parse_monitor(monitor) == jax_config.parse_monitor(
      monitor)


def test_config_derives_the_jax_experiment_paths(tmp_path):
  path = REPO / "configs" / "eccv20" / "msrvtt_jsfusion_trainval.json"
  port = port_config.Config(port_config.load(path).raw,
                            config_path=path, save_root=str(tmp_path))
  jax = jax_config.Config(jax_config.load(path).raw, config_path=path,
                          save_root=str(tmp_path))
  assert port.exper_name == jax.exper_name == "msrvtt_jsfusion_trainval"
  assert port.save_dir == jax.save_dir
  assert port.web_dirs == jax.web_dirs
  assert port.vid_bert_params == port_config.BertParams(
      **jax.vid_bert_params.__dict__)
  assert (port.seed, port.cross_seed) == (jax.seed, jax.cross_seed)


def test_data_side_imports_no_jax(tmp_path):
  """The port's data side, tokenizer and config import nothing of JAX or
  of the JAX package (the pattern of test_port_imports_no_jax)."""
  code = (
      "import sys, numpy as np\n"
      "before = set(sys.modules)\n"
      "from mmt_tpu_torch import config, experts, registry, tokenization\n"
      "from mmt_tpu_torch.data import loader, synthetic\n"
      "from mmt_tpu_torch.utils import checks, timing, visualizer\n"
      f"root = {str(tmp_path)!r}\n"
      "d = synthetic.generate(root, num_videos=6, num_test=2,\n"
      "                       experts={'rgb': 2048}, cut='c')\n"
      "tok = tokenization.create_tokenizer('bertftn', root + '/vocab.txt')\n"
      "dl = loader.ExpertDataLoader(\n"
      "    mix=[{'dataset_name': 'MSRVTT', 'cut_name': 'c',\n"
      "          'data_dir': str(d), 'split_name': 'val'}],\n"
      "    num_workers=0, batch_size=2,\n"
      "    raw_input_dims={'rgb': {'dim': 2048, 'idx': 5}}, tokenizer=tok)\n"
      "b = next(loader.device_prefetch(iter(dl['loader']), 'cpu'))\n"
      "assert b['features']['rgb'].shape[0] == 2\n"
      "new = set(sys.modules) - before\n"
      "bad = sorted(m for m in new if m.split('.')[0] in\n"
      "             ('jax', 'jaxlib', 'flax', 'optax', 'mmt_tpu', 'h5py'))\n"
      "print('BAD', bad)\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "BAD []" in proc.stdout
