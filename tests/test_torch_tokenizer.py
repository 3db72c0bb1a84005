"""The port's byte-level BPE tokenizer (``utils/tokenizer.py``) against the
JAX package's, case for case of ``tests/test_tokenizer.py``.

Training on the same corpus gives the same merges; the same texts give
the same ids through both packages and through the port's Python and
native paths; saved model files are byte-identical and load into each
other. The native library is built with ``make -C native`` as the
reference's test builds it; its cases skip only where g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess

import pytest

from triton_kubernetes_tpu.utils.tokenizer import BpeTokenizer as JBpe
from triton_kubernetes_tpu_torch.utils import tokenizer as tkmod
from triton_kubernetes_tpu_torch.utils.tokenizer import BpeTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
LIB = os.path.join(NATIVE_DIR, "libtktok.so")

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "the five boxing wizards jump quickly",
    "sphinx of black quartz judge my vow",
    "how vexingly quick daft zebras jump",
] * 4
TEXTS = CORPUS + ["héllo wörld 😀", "", "a", "日本語テキスト",
                  "zzz unseen bytes \x00\x7f", "the the the the",
                  bytes(range(256))]


def _ensure_lib() -> bool:
    if os.path.isfile(LIB):
        return True
    if shutil.which("g++") is None:
        return False
    return subprocess.run(["make", "-C", NATIVE_DIR],
                          capture_output=True).returncode == 0


@pytest.fixture(scope="module")
def native_lib():
    """The native library, built here if need be; skips where g++ is
    missing."""
    if not _ensure_lib():
        pytest.skip("g++ unavailable; native/libtktok.so not built")
    return LIB


@pytest.fixture(scope="module")
def tok():
    return BpeTokenizer.train(CORPUS, vocab_size=300)


@pytest.fixture(scope="module")
def jtok():
    return JBpe.train(CORPUS, vocab_size=300)


@pytest.mark.parametrize("vocab", [259, 280, 300, 400])
def test_training_gives_the_reference_merges(vocab):
    tok, jtok = BpeTokenizer.train(CORPUS, vocab), JBpe.train(CORPUS, vocab)
    assert tok.merges == jtok.merges
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == (
        jtok.bos_id, jtok.eos_id, jtok.pad_id, jtok.vocab_size)


def test_training_learns_merges(tok):
    assert len(tok.merges) > 10
    assert tok.vocab_size == 259 + len(tok.merges)
    ids = tok.encode("the quick brown fox", native=False)
    assert len(ids) < len("the quick brown fox")
    with pytest.raises(ValueError, match="259"):
        BpeTokenizer.train(CORPUS, vocab_size=258)


def test_python_ids_equal_the_reference(tok, jtok):
    for text in TEXTS:
        assert tok.encode(text, native=False) == jtok.encode(
            text, native=False), text
        ids = tok.encode(text, add_bos=True, add_eos=True, native=False)
        assert ids == jtok.encode(text, add_bos=True, add_eos=True,
                                  native=False)
        assert tok.decode_bytes(ids) == jtok.decode_bytes(ids)


def test_roundtrip_utf8_and_binary(tok):
    for text in ["hello world", "héllo wörld 😀", "", "a", "日本語テキスト"]:
        assert tok.decode(tok.encode(text)) == text
    raw = bytes(range(256))
    assert tok.decode_bytes(tok.encode(raw)) == raw


def test_specials_and_bounds(tok):
    ids = tok.encode("hi", add_bos=True, add_eos=True)
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == "hi"
    with pytest.raises(ValueError, match="out of range"):
        tok.decode_bytes([tok.vocab_size])
    with pytest.raises(ValueError, match="out of range"):
        tok.decode_bytes([-1])


def test_save_load_identical_to_the_reference(tok, jtok, tmp_path):
    path, jpath = str(tmp_path / "tok.model"), str(tmp_path / "jtok.model")
    tok.save(path)
    jtok.save(jpath)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    tok2, jtok2 = BpeTokenizer.load(jpath), JBpe.load(path)
    assert tok2.merges == jtok2.merges == tok.merges
    for text in CORPUS:
        assert tok2.encode(text, native=False) == tok.encode(
            text, native=False)


def test_training_deterministic():
    a = BpeTokenizer.train(CORPUS, vocab_size=280)
    b = BpeTokenizer.train(CORPUS, vocab_size=280)
    assert a.merges == b.merges


def test_merge_pair_is_the_references():
    from triton_kubernetes_tpu.utils.tokenizer import _merge_pair as jmerge

    for ids, pair in (([1, 2, 1, 2, 3], (1, 2)), ([7, 7, 7, 7, 7], (7, 7)),
                      ([], (1, 2)), ([1], (1, 2)), ([2, 1, 2], (1, 2))):
        assert tkmod._merge_pair(ids, pair, 99) == jmerge(ids, pair, 99)


def test_load_rejects_out_of_range_merge(tmp_path):
    fwd = tmp_path / "fwd.model"
    fwd.write_text("tkbpe v1 2\n97 257\n98 99\n")
    with pytest.raises(ValueError, match="merge 0"):
        BpeTokenizer.load(str(fwd))
    neg = tmp_path / "neg.model"
    neg.write_text("tkbpe v1 1\n-1 98\n")
    with pytest.raises(ValueError, match="merge 0"):
        BpeTokenizer.load(str(neg))
    bad = tmp_path / "bad.model"
    bad.write_text("not a model\n")
    with pytest.raises(ValueError, match="tkbpe v1"):
        BpeTokenizer.load(str(bad))


def test_native_requested_without_a_model_file_raises(tok, monkeypatch):
    """Auto-detection falls back to Python where the native path cannot
    run; native=True raises instead (no library, or no model file)."""
    fresh = BpeTokenizer(tok.merges)
    assert fresh.encode("the fox") == tok.encode("the fox", native=False)
    with pytest.raises(RuntimeError, match="native"):
        fresh.encode("the fox", native=True)
    monkeypatch.setattr(tkmod, "_find_native_lib", lambda: None)
    with pytest.raises(RuntimeError, match="libtktok"):
        BpeTokenizer(tok.merges).encode("x", native=True)


def test_native_library_is_found_where_the_reference_finds_it():
    from triton_kubernetes_tpu.utils import tokenizer as jmod

    assert tkmod._find_native_lib() == jmod._find_native_lib()


def test_native_matches_python(tok, tmp_path, native_lib):
    path = str(tmp_path / "tok.model")
    tok.save(path)
    t = BpeTokenizer.load(path)
    assert t._native_lib()
    for text in TEXTS:
        assert t.encode(text, native=True) == t.encode(text, native=False)
    # A saved tokenizer detects the library itself.
    assert t.encode("the quick") == t.encode("the quick", native=True)


def test_native_rejects_garbage_model(tmp_path, native_lib):
    bad = tmp_path / "bad.model"
    bad.write_text("not a model\n")
    lib = ctypes.CDLL(native_lib)
    lib.tok_load.restype = ctypes.c_void_p
    lib.tok_load.argtypes = [ctypes.c_char_p]
    assert lib.tok_load(str(bad).encode()) is None


def test_native_matches_python_large_document(tok, tmp_path, native_lib):
    path = str(tmp_path / "tok.model")
    tok.save(path)
    t = BpeTokenizer.load(path)
    doc = ("the quick brown fox " * 500) + ("aaaa" * 300) + "".join(
        CORPUS * 20)
    assert t.encode(doc, native=True) == t.encode(doc, native=False)
