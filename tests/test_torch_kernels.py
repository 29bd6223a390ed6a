"""repro_torch kernels' plain versions vs the JAX package's kernels: the
encode parse against ``encode_batch_pallas`` (interpret mode) and the jitted
jnp oracle, the decode against ``decode_compact`` (interpret mode), and the
wrappers' CPU dispatch and input checks — all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_onpair16
from repro.core.codec import Decoder as RefDecoder
from repro.kernels import onpair_decode as jax_decode
from repro.kernels import onpair_encode as jax_encode
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.codec import Decoder, Encoder
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import onpair_decode, onpair_encode, ops, ref

SAMPLE = 1 << 19
CPU = torch.device("cpu")
EDGE = [b"", b"a", b"ab", b"abcdefgh", b"abcdefghi", b"x" * 100,
        bytes(range(256)), b"\x00" * 20, b"abracadabra abracadabra"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    return load_dataset("book_titles", SAMPLE)


@pytest.fixture(scope="module")
def dicts(titles):
    """(reference compressor, reference jnp DeviceDict, port dictionary,
    port DeviceDict on the CPU), trained alike."""
    comp = make_onpair16(sample_bytes=SAMPLE, seed=7)
    comp.train(titles)
    d = PackedDictionary.build(train_dictionary(
        titles, OnPairConfig.onpair16(sample_bytes=SAMPLE, seed=7)).entries)
    return comp, jax_ref.DeviceDict.build(comp.dictionary), d, \
        ref.DeviceDict.build(d, CPU)


def _by_cap(titles, lo, hi, n):
    """n strings with lo < len <= hi (long ones joined from titles)."""
    if hi > 128:
        joined = [b" / ".join(titles[i : i + 6]) for i in range(0, 60 * n, 6)]
        return [s[:hi] for s in joined if len(s) > lo][:n]
    return [s for s in titles if lo < len(s) <= hi][:n]


def _encode_three_ways(dicts, strings, cap, max_tokens):
    """Port plain encode, reference Pallas kernel (interpret), reference jnp
    oracle on the same padded batch; asserts all equal, returns the port's."""
    _, jdd, _, dd = dicts
    data, lens = ops.pack_strings(strings, pad_len=cap)
    toks, n = ref.encode_batch_ref(torch.from_numpy(data),
                                   torch.from_numpy(lens), dd, max_tokens)
    jdata = jnp.asarray(data.astype(np.int32))
    jlens = jnp.asarray(lens)
    for fn in (jax_encode.encode_batch_pallas, jax_ref.encode_batch_ref_jit):
        jt, jn = fn(jdata, jlens, jdd, max_tokens)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    return toks.numpy(), n.numpy()


# --------------------------------------------------------------- encode
def test_encode_edge_strings_match_reference(dicts):
    toks, n = _encode_three_ways(dicts, EDGE, 256, 256)
    assert n[0] == 0 and not toks[0].any()


@pytest.mark.parametrize("cap,lo", [(32, 0), (128, 32), (512, 128)])
def test_encode_corpus_strings_match_reference(dicts, titles, cap, lo):
    strings = _by_cap(titles, lo, cap, 12)
    assert len(strings) == 12
    toks, n = _encode_three_ways(dicts, strings + [b""] * 4, cap, cap)
    comp = dicts[0]
    for i, s in enumerate(strings):  # and the reference's host parse
        assert toks[i, : n[i]].astype("<u2").tobytes() == comp.compress_string(s)


@pytest.mark.parametrize("max_tokens", [1, 3, 5])
def test_encode_truncates_at_max_tokens(dicts, titles, max_tokens):
    strings = _by_cap(titles, 32, 128, 6) + EDGE[:3]
    _, n = _encode_three_ways(dicts, strings, 128, max_tokens)
    assert n.max() <= max_tokens


def test_encode_wrapper_on_cpu_runs_plain_version(dicts, titles):
    dd = dicts[3]
    data, lens = ops.pack_strings(titles[:8], pad_len=128)
    launches, calls = onpair_encode.encode_batch.launches, ref.encode_batch_ref.calls
    toks, n = onpair_encode.encode_batch(torch.from_numpy(data),
                                         torch.from_numpy(lens), dd, 128)
    assert onpair_encode.encode_batch.launches == launches
    assert ref.encode_batch_ref.calls == calls + 1
    want_t, want_n = ref.encode_batch_ref(torch.from_numpy(data),
                                          torch.from_numpy(lens), dd, 128)
    assert torch.equal(toks, want_t) and torch.equal(n, want_n)
    toks, n = onpair_encode.encode_batch(torch.from_numpy(data),
                                         torch.from_numpy(lens), dd, 0)
    assert toks.shape == (8, 0) and not n.any()


def test_encode_wrapper_checks_inputs(dicts):
    dd = dicts[3]
    data, lens = ops.pack_strings([b"abc", b"de"], pad_len=8)
    D, L = torch.from_numpy(data), torch.from_numpy(lens)
    for bad in ((D.to(torch.int32), L), (D, L.to(torch.int64)),
                (D[:, :8], L), (D.t().contiguous().t(), L)):
        with pytest.raises(ValueError):
            onpair_encode.encode_batch(*bad, dd, 8)


def test_bucketed_encode_matches_reference_parse(dicts, titles):
    """The port's bucketed path (caps 32/128/512, doubled on demand, one
    launch per cap group here) equals the reference's parse, strings longer
    than 512 B included."""
    comp, _, d, _ = dicts
    strings = titles[:150] + EDGE + [b"y" * 700]
    port = ops.OnPairDevice(d, CPU)
    want = [comp.compress_string(s) for s in strings]
    assert port.encode_to_bytes(strings) == want
    assert port.encode_len_caps == [32, 128, 512, 1024]
    assert Encoder(d, device=CPU).encode_one(strings[5]) == want[5]


def test_encoder_corpus_equals_reference_host_parse(dicts, titles):
    comp, _, d, _ = dicts
    strings = titles[:400] + EDGE
    got = Encoder(d, device=CPU).encode(strings)
    want = comp.compress(strings)
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.raw_bytes == want.raw_bytes and got.ratio == want.ratio


# --------------------------------------------------------------- decode
def _decode_both(dicts, tokens, n_tokens):
    """Port plain decode vs the reference's Pallas decode_compact
    (interpret) on the bytes up to out_len, and out_len itself."""
    comp, jdd, _, dd = dicts
    B, T = tokens.shape
    out, olen = ref.decode_batch_ref(torch.from_numpy(tokens),
                                     torch.from_numpy(n_tokens), dd.mat16, dd.lens)
    assert out.shape == (B, 16 * T + 16) and out.dtype == torch.uint8
    jout, jlen = jax_decode.decode_compact(jnp.asarray(tokens),
                                           jnp.asarray(n_tokens), jdd.mat16,
                                           jdd.lens, 16 * T)
    jout, jlen = np.asarray(jout), np.asarray(jlen)
    np.testing.assert_array_equal(olen.numpy(), jlen)
    for b in range(B):
        assert out[b, : olen[b]].numpy().tobytes() == \
            jout[b, : jlen[b]].astype(np.uint8).tobytes()
    return [out[b, : olen[b]].numpy().tobytes() for b in range(B)]


@pytest.mark.parametrize("cap", [8, 24, 64])
def test_decode_store_batches_match_reference(dicts, titles, cap):
    comp = dicts[0]
    corpus = comp.compress(titles[:300])
    lists = [np.asarray(corpus.string_tokens(i), dtype=np.int32)
             for i in range(300)]
    lists = [t for t in lists if t.size <= cap][:40]
    tokens, n = ops.pack_token_matrix(lists, pad_tokens=cap, pad_batch=48)
    got = _decode_both(dicts, tokens, n)
    assert got[: len(lists)] == [comp.dictionary.decode_tokens(t) for t in lists]
    assert got[len(lists):] == [b""] * (48 - len(lists))


def test_decode_edge_shapes_match_reference(dicts):
    comp = dicts[0]
    lens = comp.dictionary.lens
    sixteen = np.flatnonzero(lens == 16).astype(np.int32)
    assert sixteen.size >= 4
    # T = 1; rows of only 16-byte entries; n_tokens = 0
    _decode_both(dicts, np.array([[65], [sixteen[0]], [66]], np.int32),
                 np.array([1, 1, 0], np.int32))
    rows = np.tile(sixteen[:4], (3, 1))
    got = _decode_both(dicts, rows, np.array([4, 2, 0], np.int32))
    assert [len(g) for g in got] == [64, 32, 0]
    # n_tokens > T reads past the row in the reference; the port clamps to T
    out, olen = ref.decode_batch_ref(torch.tensor([[104, 105]], dtype=torch.int32),
                                     torch.tensor([7], dtype=torch.int32),
                                     dicts[3].mat16, dicts[3].lens)
    assert out[0, : olen[0]].numpy().tobytes() == b"hi"


def test_decode_empty_batch_returns_empty(dicts):
    """B = 0: the reference's Pallas path fails there, so the oracle is its
    numpy host Decoder."""
    comp, _, d, dd = dicts
    out, olen = ref.decode_batch_ref(torch.zeros((0, 5), dtype=torch.int32),
                                     torch.zeros(0, dtype=torch.int32),
                                     dd.mat16, dd.lens)
    assert out.shape == (0, 96) and olen.shape == (0,)
    corpus = comp.compress([b"abc", b"de"])
    want = RefDecoder(comp.to_artifact(), backend="numpy").multiget(corpus, [])
    assert Decoder(d, device=CPU).multiget(corpus, []) == want == []
    assert ops.OnPairDevice(d, CPU).multiget_decode([]) == []


def test_decode_wrapper_on_cpu_runs_plain_version(dicts):
    dd = dicts[3]
    tokens = torch.tensor([[65, 66, 67]], dtype=torch.int32)
    n = torch.tensor([3], dtype=torch.int32)
    launches, calls = onpair_decode.decode_compact.launches, ref.decode_batch_ref.calls
    out, olen = onpair_decode.decode_compact(tokens, n, dd.mat16, dd.lens)
    assert out[0, : olen[0]].numpy().tobytes() == b"ABC"
    assert onpair_decode.decode_compact.launches == launches
    assert ref.decode_batch_ref.calls == calls + 1


def test_decode_wrapper_checks_inputs(dicts):
    dd = dicts[3]
    t = torch.zeros((2, 3), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    for bad in ((t.long(), n, dd.mat16, dd.lens), (t, n[:1], dd.mat16, dd.lens),
                (t, n, dd.mat16.int(), dd.lens), (t, n, dd.mat16[:, :8], dd.lens),
                (t.t(), n, dd.mat16, dd.lens)):
        with pytest.raises(ValueError):
            onpair_decode.decode_compact(*bad)
    with pytest.raises(ValueError):  # ids past the dictionary never launch
        ops.OnPairDevice(dicts[2], CPU).multiget_decode(
            [np.array([dd.num_entries], np.int32)])


def test_pack_helpers_match_reference():
    lists = [np.array([1, 2, 3], np.int32), np.array([], np.int32),
             np.array([9], np.int32)]
    for kw in ({}, {"pad_tokens": 8, "pad_batch": 5}):
        for got, want in zip(ops.pack_token_matrix(lists, **kw),
                             jax_ops.pack_token_matrix(lists, **kw)):
            np.testing.assert_array_equal(got, want)
    data, lens = ops.pack_strings(EDGE, pad_len=256)
    jdata, jlens = jax_ops.pack_strings(EDGE, pad_len=256)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(lens, jlens)
