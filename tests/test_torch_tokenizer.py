"""repro_torch.core.tokenizer against the JAX package's OnPairTokenizer:
trained on the same corpus, the same dictionary; the same ids for every
string, exactly, with and without BOS/EOS; decode of special ids (skipped),
decode_fast, and dictionaries and artifacts saved by one package loaded by
the other."""

import os

import numpy as np
import pytest

from repro.core import tokenizer as R
from repro.core.artifact import DictArtifact as RefArtifact
from repro_torch.core import tokenizer as T
from repro_torch.core.artifact import DictArtifact
from repro_torch.data.synth import load_dataset

SAMPLE = 1 << 18
EDGE = [b"", b"a", b"the quick brown", b"in memory database",
        bytes(range(256)), b"\xff\xfe" * 40, "café ☃".encode()]


@pytest.fixture(scope="module")
def corpus():
    return load_dataset("book_titles", SAMPLE)


@pytest.fixture(scope="module")
def toks(corpus):
    return (R.OnPairTokenizer.train(corpus, sample_bytes=SAMPLE),
            T.OnPairTokenizer.train(corpus, sample_bytes=SAMPLE))


def test_constants():
    assert (T.PAD_ID, T.BOS_ID, T.EOS_ID, T.N_SPECIAL, T.VOCAB_SIZE) == \
        (R.PAD_ID, R.BOS_ID, R.EOS_ID, R.N_SPECIAL, R.VOCAB_SIZE) == \
        (65536, 65537, 65538, 3, 65539)


def test_same_dictionary(toks):
    ref, port = toks
    assert port.dictionary.entries == ref.dictionary.entries
    assert port.vocab_size == ref.vocab_size == T.VOCAB_SIZE


@pytest.mark.parametrize("bos,eos", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_same_ids(toks, corpus, bos, eos):
    ref, port = toks
    texts = corpus[:2000] + EDGE
    got = port.encode_batch(texts, bos=bos, eos=eos)
    want = ref.encode_batch(texts, bos=bos, eos=eos)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert got[0][0] == (T.BOS_ID if bos else got[0][0])


def test_decode_skips_special_ids(toks, corpus):
    ref, port = toks
    for text in corpus[:300] + EDGE:
        ids = port.encode(text, bos=True, eos=True)
        assert port.decode(ids) == ref.decode(ids) == text
        plain = port.encode(text)
        assert port.decode_fast(plain) == ref.decode_fast(plain) == text
    noisy = np.array([T.PAD_ID, 5, T.BOS_ID, 7, T.EOS_ID, T.PAD_ID, 9], np.int64)
    assert port.decode(noisy) == ref.decode(noisy)
    assert port.decode_fast(noisy) == ref.decode_fast(noisy)
    assert port.decode(np.array([T.PAD_ID, T.EOS_ID])) == b""


def test_save_load_and_artifacts_across_packages(toks, corpus, tmp_path):
    ref, port = toks
    texts = corpus[:500]
    port.save(str(tmp_path / "port.dict"))
    ref.save(str(tmp_path / "ref.dict"))
    for t in (T.OnPairTokenizer.load(str(tmp_path / "ref.dict")),
              T.OnPairTokenizer.load(str(tmp_path / "port.dict"))):
        assert [x.tolist() for x in t.encode_batch(texts, bos=True)] == \
            [x.tolist() for x in ref.encode_batch(texts, bos=True)]
    ref_back = R.OnPairTokenizer.load(str(tmp_path / "port.dict"))
    assert ref_back.dictionary.entries == ref.dictionary.entries
    # artifacts: the port's opens in the reference and the reverse
    path = os.path.join(tmp_path, "port.rpa")
    port.to_artifact().save(path)
    from_port = R.OnPairTokenizer.from_artifact(RefArtifact.load(path))
    ref.to_artifact().save(os.path.join(tmp_path, "ref.rpa"))
    from_ref = T.OnPairTokenizer.from_artifact(
        DictArtifact.load(os.path.join(tmp_path, "ref.rpa")))
    for text in texts[:100] + EDGE:
        want = ref.encode(text, bos=True).tolist()
        assert from_port.encode(text, bos=True).tolist() == want
        assert from_ref.encode(text, bos=True).tolist() == want
    assert T.OnPairTokenizer.from_dictionary(port.dictionary).encode(
        texts[0]).tolist() == ref.encode(texts[0]).tolist()
