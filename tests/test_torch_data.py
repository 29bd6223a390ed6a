"""repro_torch.data (the compressed corpus store and the token pipeline)
against the JAX package's ``repro.data`` on stores that both packages build
from the same strings: the tokenizer, payload and offsets, every document's
tokens, bytes and lengths, ``TokenPipeline.batch(k)`` for k in {0, 5, 17}
on one host and on host 1 of 2, and the padded eval batch, all exact; the
reference's case of ``tests/test_system.py:235`` on the port. Also the
reference's full-width vocabulary fault, which the port does not copy: the
tokenizer's ids run past a config's own vocabulary, the reference's loss
is then NaN, and the port's launcher trains on the tokenizer's vocabulary."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.data.corpus import CompressedCorpusStore as RefStore
from repro.data.pipeline import BatchSpec as RefSpec
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.data.synth import load_dataset as ref_load_dataset
from repro.models import model as RM
from repro_torch.core.tokenizer import EOS_ID, VOCAB_SIZE
from repro_torch.data.corpus import CompressedCorpusStore
from repro_torch.data.pipeline import BatchSpec, TokenPipeline
from repro_torch.data.synth import load_dataset
from repro_torch.launch.train import build_parser, train_lm
from repro_torch.models.model import build_params, loss_fn

SAMPLE = 1 << 18
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores():
    strings = load_dataset("news_headlines", SAMPLE)
    assert strings == ref_load_dataset("news_headlines", SAMPLE)
    return (CompressedCorpusStore.build(strings, sample_bytes=SAMPLE),
            RefStore.build(strings, sample_bytes=SAMPLE), strings)


def test_the_stores_are_the_reference_store(stores):
    port, ref, strings = stores
    assert port.tokenizer.dictionary.entries == ref.tokenizer.dictionary.entries
    np.testing.assert_array_equal(port.corpus.payload, ref.corpus.payload)
    np.testing.assert_array_equal(port.corpus.offsets, ref.corpus.offsets)
    assert port.n_docs == ref.n_docs == len(strings)
    assert port.compression_ratio == ref.compression_ratio
    assert port.memory_bytes == ref.memory_bytes
    np.testing.assert_array_equal(port.doc_lengths_tokens(), ref.doc_lengths_tokens())
    for i in (0, 1, 17, len(strings) // 2, len(strings) - 1):
        got = port.doc_tokens(i)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.doc_tokens(i))
        assert port.doc_bytes(i) == ref.doc_bytes(i) == strings[i]


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_batches_are_the_reference_batches(stores, n_hosts, host_id):
    port, ref, _ = stores
    kw = dict(global_batch=4, seq_len=64, n_hosts=n_hosts, host_id=host_id, seed=9)
    pipe, ref_pipe = TokenPipeline(port, BatchSpec(**kw)), RefPipeline(ref, RefSpec(**kw))
    for k in (0, 5, 17):
        got, want = pipe.batch(k), ref_pipe.batch(k)
        assert got.keys() == want.keys() == {"tokens", "targets"}
        for name in got:
            assert got[name].dtype == np.int32
            assert got[name].shape == (4 // n_hosts, 64)
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{k} {name}")
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["targets"][:, :-1])
    assert (pipe.batch(5)["tokens"] == EOS_ID).any()  # documents are packed


def test_padded_eval_batch_is_the_reference(stores):
    port, ref, _ = stores
    texts = [b"the quick brown fox", b"", b"a" * 300]
    got = TokenPipeline(port, BatchSpec(2, 8)).padded_eval_batch(texts, 32)
    want = RefPipeline(ref, RefSpec(2, 8)).padded_eval_batch(texts, 32)
    for name in ("tokens", "lengths"):
        np.testing.assert_array_equal(got[name], want[name])


def test_corpus_store_and_pipeline_resume(stores):
    """``tests/test_system.py::test_corpus_store_and_pipeline_resume`` on the
    port."""
    store, _, _ = stores
    assert store.compression_ratio > 2.0
    spec = BatchSpec(global_batch=4, seq_len=64, seed=9)
    b5 = TokenPipeline(store, spec).batch(5)
    pipe2 = TokenPipeline(store, spec)  # fresh process after restart
    np.testing.assert_array_equal(b5["tokens"], pipe2.batch(5)["tokens"])


def test_the_vocabulary_fault_of_the_reference_launcher(stores):
    """The reference's launcher keeps a config's own vocabulary without
    --smoke (mamba2-780m: 50,280) while the tokenizer emits ids up to
    65,538: ``jnp.take`` fills the rows past the vocabulary with NaN, so the
    loss is NaN. Shown here on a smoke config (vocabulary 512) and a batch
    of the pipeline. The port's model refuses such ids (an IndexError on
    the host, where the card would assert), and its launcher trains on the
    tokenizer's vocabulary at every width."""
    _, ref, _ = stores
    batch = RefPipeline(ref, RefSpec(global_batch=2, seq_len=32, seed=0)).batch(0)
    cfg = replace(REF_REGISTRY["mamba2-780m"].smoke(), dtype="float32")
    assert batch["tokens"].max() >= cfg.vocab_size
    loss = RM.loss_fn(RM.build_params(cfg, seed=0),
                      jax.tree_util.tree_map(np.asarray, batch), cfg)
    assert np.isnan(float(loss))

    params = build_params(cfg, seed=0, device=CPU)
    with pytest.raises(IndexError):
        loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)

    args = build_parser().parse_args(["--smoke", "--steps", "2", "--batch", "2",
                                      "--seq", "32", "--data-mib", "1",
                                      "--ckpt-every", "100"])
    out = train_lm(args, CPU, install_signals=False)
    assert out["cfg"].vocab_size == VOCAB_SIZE > cfg.vocab_size
    assert out["loop"].state["params"]["embed"].shape[0] == VOCAB_SIZE
    assert out["pipe"].batch(0)["tokens"].max() >= cfg.vocab_size
    assert np.all(np.isfinite(out["loop"].stats.losses))
    assert out["loop"].stats.steps_run == 2
