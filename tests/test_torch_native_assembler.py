"""The port's native batch assembler (mmt_tpu_torch/native/assembler.cc,
bound by mmt_tpu_torch/data/native_assembler.py) and its host build.

Every comparison is bitwise: the slot kinds against a numpy reference
(tests/test_native_assembler.py's cases), whole batches of the native
path against the port's Python path and against the JAX package's loader
(``num_workers=0``), and the build's rules: the library lands under
``build/mmt_tpu_torch/``, is named by a hash of its source, and a broken
compiler raises instead of falling back to Python.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from mmt_tpu.data import loader as jax_loader
from mmt_tpu.data import native_assembler as jax_nasm
from mmt_tpu_torch import _build, bench_loader
from mmt_tpu_torch import tokenization as port_tok
from mmt_tpu_torch.data import loader as port_loader
from mmt_tpu_torch.data import native_assembler as nasm
from mmt_tpu_torch.data import synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _restore_paths():
  yield
  nasm.set_enabled(None)
  jax_nasm.set_enabled(None)


# ---------------------------------------------------------------------------
# Unit level: each slot kind against a numpy reference.
# ---------------------------------------------------------------------------


def _py_reference(slots, T, D):
  feats = np.zeros((len(slots), T, D), np.float32)
  ts = np.ones((len(slots), T), np.float32)
  inds = np.zeros((len(slots), T), np.float32)
  for i, s in enumerate(slots):
    if s.kind == 0:
      continue
    if s.kind == 1:
      feats[i], ts[i], inds[i] = s.feat, s.t, s.ind
      continue
    rows = s.pick if s.pick is not None else np.arange(s.k)
    feats[i, :s.k] = s.feat[rows]
    ts[i, :s.k] = (s.t[rows] - s.t_start) / s.t_window + 2
    inds[i, :s.k] = 1
  return feats, ts, inds


def test_feature_slot_kinds_bit_exact(rng):
  T, D = 6, 5
  block = (rng.randn(T, D).astype(np.float32),
           rng.randn(T).astype(np.float32),
           (rng.rand(T) > 0.5).astype(np.float32))
  f64_src = rng.randn(9, D)                      # float64 features
  f32_src = rng.randn(4, D).astype(np.float32)
  t9 = np.sort(rng.rand(9) * 50)
  t4 = np.sort(rng.rand(4) * 50)
  pick = np.sort(rng.choice(9, size=T, replace=False)).astype(np.int64)
  slots = [
      nasm.FeatSlot(0, 0, None, None, None, None, 0.0, 1.0),
      nasm.FeatSlot(1, 0, *block, None, 0.0, 1.0),
      nasm.FeatSlot(2, T, f64_src, t9, None, pick, 1.5, 3.0),
      nasm.FeatSlot(2, 4, f32_src, t4, None, None, 0.0, 1.0),  # pad 2 rows
  ]
  got = nasm.assemble_features(slots, T, D)
  want = _py_reference(slots, T, D)
  for g, w in zip(got, want):
    assert g.dtype == np.float32
    np.testing.assert_array_equal(g, w)


def test_float64_cast_rounds_to_nearest_even():
  """Values halfway between two float32s, and beyond float32's range,
  cast as numpy's astype does."""
  D = 4
  one = np.float64(1.0)
  half_ulp = np.float64(np.spacing(np.float32(1.0))) / 2
  src = np.array([[one + half_ulp, one + 3 * half_ulp, -one - half_ulp,
                   1e39]])
  got = nasm.assemble_rows([nasm.RowSlot(2, src)], D)
  with np.errstate(over="ignore"):
    np.testing.assert_array_equal(got[0], src[0].astype(np.float32))


@pytest.mark.parametrize("kind", ("preformed", "raw"))
def test_feature_slot_guards(rng, kind):
  T, D = 4, 3
  if kind == "preformed":
    bad = nasm.FeatSlot(1, 0, np.zeros((5, D), np.float32),
                        np.zeros(5, np.float32), np.zeros(5, np.float32),
                        None, 0.0, 1.0)
  else:
    bad = nasm.FeatSlot(2, 9, rng.randn(9, D), np.zeros(9), None, None,
                        0.0, 1.0)
  with pytest.raises(ValueError):
    nasm.assemble_features([bad], T, D)


def test_raw_slot_ok_needs_contiguous_sources_of_known_dtypes(rng):
  f, t = rng.randn(6, 4), rng.rand(6)
  assert nasm.raw_slot_ok(f, t)
  assert nasm.raw_slot_ok(f.astype(np.float32), t)
  assert not nasm.raw_slot_ok(f[:, ::2], t)
  assert not nasm.raw_slot_ok(f.astype(np.float16), t)
  assert not nasm.raw_slot_ok(f, t.astype(np.float32))


def test_rows_bit_exact(rng):
  D = 7
  r64 = rng.randn(1, D)
  r32 = rng.randn(D).astype(np.float32)
  out = nasm.assemble_rows(
      [nasm.RowSlot(0, None), nasm.RowSlot(2, r64), nasm.RowSlot(2, r32)],
      D)
  np.testing.assert_array_equal(out[0], np.zeros(D, np.float32))
  np.testing.assert_array_equal(out[1], r64[0].astype(np.float32))
  np.testing.assert_array_equal(out[2], r32)


# ---------------------------------------------------------------------------
# Loader level: whole batches, native vs Python, same RNG stream.
# ---------------------------------------------------------------------------

EXPERTS = {"rgb": 32, "s3d": 16, "vggish": 8}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
  root = tmp_path_factory.mktemp("port_nasm")
  data_dir = synthetic.generate(root, num_videos=12, num_test=4,
                                experts=EXPERTS, captions_per_video=3,
                                max_feats=9)
  return data_dir, root / "vocab.txt"


def _batches(corpus, training, native, n, missing_expert=False,
             package="port"):
  """The first ``n`` batches of one package's loader on one path: the
  port's with its tokenizer on the same path, or the JAX package's."""
  data_dir, vocab = corpus
  dims = dict(EXPERTS)
  if missing_expert:
    dims["ocr"] = 11    # a registry expert absent from the corpus
  if package == "port":
    nasm.set_enabled(native)
    tok = bench_loader.tokenizers(vocab)["native" if native else "python"]
    module = port_loader
  else:
    from mmt_tpu import tokenization as jax_tok
    jax_nasm.set_enabled(native)
    module, tok = jax_loader, jax_tok.WordPieceTokenizer(vocab)
  np.random.seed(7)
  mix = [{"dataset_name": "MSRVTT", "cut_name": "jsfusion",
          "data_dir": str(data_dir),
          "split_name": "trainval" if training else "test",
          "max_text_words": 10,
          # max_expert_tokens below max_feats so training draws random
          # picks (the raw descriptor path the block memo cannot cache)
          "max_expert_tokens": 5,
          "query_shuffling": "shufk1" if training else "indiv",
          "temporal_encoding_window": 1, "mix_weight": 1.0}]
  ldr = module.ExpertDataLoader(mix=mix, num_workers=0, batch_size=4,
                                raw_input_dims=dims, training=training,
                                tokenizer=tok, loaded_data={})
  it = iter(ldr["loader"])
  return [next(it) for _ in range(n)], dims


def _assert_batches_equal(a, b, dims):
  for ba, bb in zip(a, b):
    for key in ("token_ids", "query_masks"):
      assert ba[key].dtype == bb[key].dtype
      np.testing.assert_array_equal(ba[key], bb[key], err_msg=key)
    for key in ("features", "features_t", "features_ind",
                "features_avgpool", "features_maxpool"):
      for e in dims:
        assert bb[key][e].dtype == ba[key][e].dtype == np.float32
        np.testing.assert_array_equal(ba[key][e], bb[key][e],
                                      err_msg=f"{key}/{e}")
    words = lambda b: [[np.asarray(c).tolist() for c in pair]
                       for pair in b["raw_captions"]]
    assert words(ba) == words(bb)


@pytest.mark.parametrize("training", (False, True), ids=("eval", "train"))
@pytest.mark.parametrize("missing_expert", (False, True),
                         ids=("all", "missing"))
def test_loader_native_matches_python(corpus, training, missing_expert):
  n = 3 if training else 1
  a, dims = _batches(corpus, training, False, n, missing_expert)
  b, _ = _batches(corpus, training, True, n, missing_expert)
  _assert_batches_equal(a, b, dims)


@pytest.mark.parametrize("training", (False, True), ids=("eval", "train"))
@pytest.mark.parametrize("missing_expert", (False, True),
                         ids=("all", "missing"))
def test_native_batches_equal_the_jax_loader(corpus, training,
                                             missing_expert):
  """The port's native path against the JAX package's Python path."""
  n = 3 if training else 1
  want, dims = _batches(corpus, training, False, n, missing_expert,
                        package="jax")
  got, _ = _batches(corpus, training, True, n, missing_expert)
  _assert_batches_equal(want, got, dims)


def test_loader_native_deterministic_across_epochs(corpus):
  """Eval batches stay bitwise the same across epochs on the native path
  (the reference's seeded eval subsampling, base/base_dataset.py:101-104),
  and train batches drawn from the same seed are the same."""
  (a1,), dims = _batches(corpus, False, True, 1)
  (a2,), _ = _batches(corpus, False, True, 1)
  _assert_batches_equal([a1], [a2], dims)
  t1, _ = _batches(corpus, True, True, 2)
  t2, _ = _batches(corpus, True, True, 2)
  _assert_batches_equal(t1, t2, dims)


def test_native_samples_carry_descriptors(corpus):
  """The native path is the default and emits descriptors; collate turns
  them into the Python path's arrays."""
  nasm.set_enabled(None)
  assert nasm.enabled()
  data_dir, vocab = corpus
  ds = port_loader.ExpertDataLoader(
      mix=[{"dataset_name": "MSRVTT", "cut_name": "jsfusion",
            "data_dir": str(data_dir), "split_name": "test",
            "max_expert_tokens": 5}],
      num_workers=0, batch_size=2, raw_input_dims=EXPERTS,
      tokenizer=port_tok.WordPieceTokenizer(vocab))["dataset"]
  vid = ds[0]["vid_tensors"]
  assert set(vid) == {"feat_slots", "avg_slots", "max_slots", "feat_T"}
  assert all(isinstance(s, nasm.FeatSlot)
             for slots in vid["feat_slots"].values() for s in slots)


# ---------------------------------------------------------------------------
# The switch and the build: no silent fallback.
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
  """A build directory of its own and no library loaded yet."""
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(nasm, "_lib", None)
  monkeypatch.setattr(nasm, "_enabled", None)
  monkeypatch.setattr(port_tok, "_NATIVE_LIB", None)
  return tmp_path


@pytest.mark.parametrize("value,want", (("0", False), ("off", False),
                                        ("1", True), ("on", True),
                                        ("", True)))
def test_switch_values(monkeypatch, tmp_path, value, want):
  monkeypatch.setenv("MMT_TPU_NATIVE_ASSEMBLY", value)
  monkeypatch.setattr(nasm, "_enabled", None)
  assert nasm.enabled() is want
  monkeypatch.setenv("MMT_TPU_DISABLE_NATIVE", value)
  tok = port_tok.WordPieceTokenizer(synthetic.write_vocab(tmp_path / "v.txt"))
  assert (tok._native is None) is (value in ("1", "on"))


def test_switches_refuse_an_unknown_value(monkeypatch, tmp_path):
  monkeypatch.setenv("MMT_TPU_NATIVE_ASSEMBLY", "auto")
  monkeypatch.setattr(nasm, "_enabled", None)
  with pytest.raises(ValueError, match="MMT_TPU_NATIVE_ASSEMBLY"):
    nasm.enabled()
  monkeypatch.setenv("MMT_TPU_DISABLE_NATIVE", "yes")
  with pytest.raises(ValueError, match="MMT_TPU_DISABLE_NATIVE"):
    port_tok.WordPieceTokenizer(synthetic.write_vocab(tmp_path / "v.txt"))


def test_library_lands_in_the_build_directory():
  path = _build.build_host("assembler.cc")
  assert path.parent == REPO / "build" / "mmt_tpu_torch"
  assert path.name.startswith("libassembler_") and path.suffix == ".so"
  assert _build.build_host("assembler.cc") == path      # cached
  assert "build/" in (REPO / ".gitignore").read_text().split()


def test_an_edited_source_gets_a_new_hash(monkeypatch, fresh_build):
  native = fresh_build / "native"
  native.mkdir()
  src = (_build.NATIVE / "assembler.cc").read_text()
  (native / "assembler.cc").write_text(src)
  monkeypatch.setattr(_build, "NATIVE", native)
  first = _build.build_host("assembler.cc")
  (native / "assembler.cc").write_text(src + "\n// edited\n")
  second = _build.build_host("assembler.cc")
  assert first != second and first.exists() and second.exists()
  assert first.parent == second.parent == fresh_build / "build"


@pytest.mark.parametrize("cxx", ("/bin/false", "/nonexistent/g++"))
def test_a_broken_compiler_raises_and_does_not_fall_back(monkeypatch,
                                                         fresh_build, cxx):
  monkeypatch.setenv("CXX", cxx)
  monkeypatch.delenv("MMT_TPU_NATIVE_ASSEMBLY", raising=False)
  monkeypatch.delenv("MMT_TPU_DISABLE_NATIVE", raising=False)
  with pytest.raises(RuntimeError, match=cxx):
    nasm.enabled()
  assert nasm._enabled is None            # still undecided: no fallback
  with pytest.raises(RuntimeError, match=cxx):
    nasm.set_enabled(True)
  vocab = synthetic.write_vocab(fresh_build / "vocab.txt")
  with pytest.raises(RuntimeError, match=cxx):
    port_tok.WordPieceTokenizer(vocab)
  assert not (fresh_build / "build").exists() or not list(
      (fresh_build / "build").glob("*.so"))


def test_the_python_paths_need_no_compiler(monkeypatch, fresh_build):
  """The two switches are the way to the Python paths: with them set, a
  broken compiler is never run."""
  monkeypatch.setenv("CXX", "/bin/false")
  monkeypatch.setenv("MMT_TPU_NATIVE_ASSEMBLY", "0")
  monkeypatch.setenv("MMT_TPU_DISABLE_NATIVE", "1")
  assert nasm.enabled() is False
  tok = port_tok.WordPieceTokenizer(
      synthetic.write_vocab(fresh_build / "vocab.txt"))
  assert tok._native is None
  assert tok.tokenize("a man cooks") == ["a", "man", "cook", "##s"]
  assert tok.texts == {"native": 0, "python": 1}


def test_native_side_imports_no_jax_and_loads_only_its_own_libraries(
    tmp_path):
  """The assembler's binding and the tokenizer, used end to end, import
  nothing of JAX or of the JAX package and map no library of the JAX
  package's native/ directory: only the port's builds."""
  code = (
      "import pathlib, sys\n"
      "before = set(sys.modules)\n"
      "from mmt_tpu_torch import tokenization\n"
      "from mmt_tpu_torch.data import loader, native_assembler, synthetic\n"
      f"root = {str(tmp_path)!r}\n"
      "d = synthetic.generate(root, num_videos=6, num_test=2,\n"
      "                       experts={'rgb': 64}, cut='c', max_feats=9)\n"
      "tok = tokenization.create_tokenizer('bertftn', root + '/vocab.txt')\n"
      "assert native_assembler.enabled() and tok._native is not None\n"
      "dl = loader.ExpertDataLoader(\n"
      "    mix=[{'dataset_name': 'MSRVTT', 'cut_name': 'c',\n"
      "          'data_dir': str(d), 'split_name': 'trainval',\n"
      "          'max_expert_tokens': 4}],\n"
      "    num_workers=2, batch_size=2, training=True,\n"
      "    raw_input_dims={'rgb': {'dim': 64, 'idx': 5}}, tokenizer=tok)\n"
      "it = iter(dl['loader'])\n"
      "b = next(it)\n"
      "it.close()\n"
      "assert b['features']['rgb'].shape == (2, 4, 64)\n"
      "assert tok.texts['native'] > 0\n"
      "new = set(sys.modules) - before\n"
      "bad = sorted(m for m in new if m.split('.')[0] in\n"
      "             ('jax', 'jaxlib', 'flax', 'optax', 'mmt_tpu', 'h5py'))\n"
      "libs = sorted({l.split()[-1] for l in open('/proc/self/maps')\n"
      "               if l.rstrip().endswith('.so')})\n"
      "print('BAD', bad)\n"
      "print('LIBS', [l for l in libs if '/repo' in l or 'mmt' in l])\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "BAD []" in proc.stdout
  libs = eval(proc.stdout.split("LIBS ", 1)[1].splitlines()[0])
  native_dir = str(REPO / "native") + "/"
  assert not [l for l in libs if l.startswith(native_dir)], libs
  built = str(REPO / "build" / "mmt_tpu_torch") + "/"
  names = sorted(pathlib.Path(l).name.split("_")[0] for l in libs
                 if l.startswith(built))
  assert names == ["libassembler", "libwordpiece"], libs
