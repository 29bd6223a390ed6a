"""Full-stream decode in repro_torch against the JAX package, exactly: the
plain version ``decode_tokens_ref`` against ``decode_tokens_pallas``
(``decode_gather`` in interpret mode) and the jnp oracle ``decode_ref``;
``OnPairDevice.decode_stream`` and ``Decoder.decode_all`` against the
reference's; and the store's ``scan`` against the reference store's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_onpair16
from repro.core.codec import Decoder as RefDecoder
from repro.kernels import onpair_decode as jax_decode
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.store import CompressedStringStore as RefStore
from repro_torch.core.codec import Decoder
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import onpair_decode, ops, ref
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 18
SEG = 256
CPU = torch.device("cpu")

_decode_ref_jit = jax.jit(jax_ref.decode_ref, static_argnames=("max_out",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    strings = load_dataset("book_titles", SAMPLE)
    strings[3] = b""
    strings[100] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = bytes(range(256))
    return strings


@pytest.fixture(scope="module")
def dicts(titles):
    """(reference compressor, reference device, port dictionary, port
    DeviceDict on the CPU) over the same entries."""
    comp = make_onpair16(sample_bytes=SAMPLE, seed=7)
    comp.train(titles)
    d = PackedDictionary.build(comp.dictionary.entries)
    return comp, jax_ops.OnPairDevice(comp.dictionary), d, \
        ref.DeviceDict.build(d, CPU)


def _decode_three_ways(dicts, tokens, n, max_out, tile=1024):
    """Port plain version vs the reference's decode_gather pipeline
    (interpret mode, tokens zero-padded to the tile) and its jnp oracle.
    Asserts out and out_len equal; returns the port's (out, out_len)."""
    _, jdev, _, dd = dicts
    out, out_len = ref.decode_tokens_ref(torch.from_numpy(tokens), n, dd.mat16,
                                         dd.lens, max_out)
    assert out.dtype == torch.uint8 and out.shape == (max_out,)
    T = tokens.size
    padded = np.zeros(max(-(-T // tile), 1) * tile, np.int32)
    padded[:T] = tokens
    jout, jlen = jax_decode.decode_tokens_pallas(
        jnp.asarray(padded), jnp.int32(n), jdev.dd.mat16, jdev.dd.lens, max_out,
        tile=tile)
    oout, olen = _decode_ref_jit(jnp.asarray(tokens), jnp.int32(n),
                                 jdev.dd.mat16, jdev.dd.lens, max_out=max_out)
    for want, want_len in ((jout, jlen), (oout, olen)):
        assert int(out_len) == int(want_len)
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(want).astype(np.uint8))
    return out.numpy(), int(out_len)


def _random_ids(d, n, seed):
    return np.random.default_rng(seed).integers(0, d.num_entries, n).astype(np.int32)


@pytest.mark.parametrize("T", [1, 1023, 1024, 1025])
def test_stream_tile_edges_match_reference(dicts, T):
    d = dicts[2]
    tokens = _random_ids(d, T, T)
    out, out_len = _decode_three_ways(dicts, tokens, T, int(d.lens[tokens].sum()))
    assert out.tobytes() == b"".join(d.entries[t] for t in tokens)


@pytest.mark.parametrize("n,cut", [(700, 0), (1025, 0), (1025, 100), (3, 40)])
def test_stream_n_tokens_and_max_out_cuts_match_reference(dicts, n, cut):
    """n_tokens < T masks the tail; max_out < out_len drops the bytes past
    it, out_len still counting them."""
    d = dicts[2]
    tokens = _random_ids(d, 2048, n)
    full = int(d.lens[tokens[:n]].sum())
    out, out_len = _decode_three_ways(dicts, tokens, n, max(full - cut, 0))
    assert out_len == full
    assert out.tobytes() == b"".join(d.entries[t] for t in tokens[:n])[: full - cut]


def test_stream_max_out_past_out_len_is_zero_filled(dicts):
    d = dicts[2]
    tokens = _random_ids(d, 300, 5)
    full = int(d.lens[tokens].sum())
    out, out_len = _decode_three_ways(dicts, tokens, 300, full + 37)
    assert out_len == full and not out[full:].any()


@pytest.mark.parametrize("width", [16, 1])
def test_stream_all_16_and_all_1_byte_tokens(dicts, width):
    d = dicts[2]
    pool = np.flatnonzero(d.lens == width).astype(np.int32)
    assert pool.size >= 8
    tokens = np.resize(pool, 1500)
    out, out_len = _decode_three_ways(dicts, tokens, tokens.size,
                                      width * tokens.size)
    assert out_len == width * tokens.size


def test_stream_random_ids_match_reference(dicts):
    """2^16 random ids through all three; 2^20 against the jnp oracle."""
    d = dicts[2]
    tokens = _random_ids(d, 1 << 16, 16)
    _decode_three_ways(dicts, tokens, tokens.size, int(d.lens[tokens].sum()))
    tokens = _random_ids(d, 1 << 20, 20)
    max_out = int(d.lens[tokens].sum())
    out, out_len = ref.decode_tokens_ref(torch.from_numpy(tokens), tokens.size,
                                         dicts[3].mat16, dicts[3].lens, max_out)
    jdev = dicts[1]
    want, want_len = _decode_ref_jit(jnp.asarray(tokens), jnp.int32(tokens.size),
                                     jdev.dd.mat16, jdev.dd.lens, max_out=max_out)
    assert int(out_len) == int(want_len) == max_out
    np.testing.assert_array_equal(out.numpy(), np.asarray(want).astype(np.uint8))


def test_stream_of_a_store_segment_and_the_whole_corpus(dicts, titles):
    comp, _, d, _ = dicts
    corpus = comp.compress(titles)
    tokens = np.asarray(corpus.payload.view("<u2"), np.int32)
    seg = tokens[: int(corpus.offsets[SEG]) // 2]
    for stream, strings in ((seg, titles[:SEG]), (tokens, titles)):
        max_out = int(d.lens[stream].sum())
        if stream is seg:
            out, _ = _decode_three_ways(dicts, stream, stream.size, max_out)
        else:  # the whole corpus: the jnp oracle (interpret mode is slow)
            out, out_len = ref.decode_tokens_ref(torch.from_numpy(stream),
                                                 stream.size, dicts[3].mat16,
                                                 dicts[3].lens, max_out)
            out = out.numpy()
        assert out.tobytes() == b"".join(strings)


@pytest.mark.parametrize("T,n", [(0, 0), (5, 0), (5, -3)])
def test_stream_empty_returns_zeros_without_a_launch(dicts, T, n):
    dd = dicts[3]
    tokens = torch.zeros(T, dtype=torch.int32)
    launches, calls = onpair_decode.decode_tokens.launches, ref.decode_tokens_ref.calls
    out, out_len = onpair_decode.decode_tokens(tokens, n, dd.mat16, dd.lens, 4)
    assert onpair_decode.decode_tokens.launches == launches
    assert ref.decode_tokens_ref.calls == calls + 1  # CPU: the plain version
    assert out.tolist() == [0, 0, 0, 0] and int(out_len) == 0
    jout, jlen = _decode_ref_jit(jnp.asarray(np.zeros(T, np.int32)), jnp.int32(n),
                                 dicts[1].dd.mat16, dicts[1].dd.lens, max_out=4)
    assert np.asarray(jout).tolist() == out.tolist() and int(jlen) == 0


def test_stream_wrapper_checks_inputs(dicts):
    dd = dicts[3]
    t = torch.zeros(6, dtype=torch.int32)
    for bad in ((t.long(), 6, dd.mat16, dd.lens, 8),
                (t[None], 6, dd.mat16, dd.lens, 8),
                (t[::2], 3, dd.mat16, dd.lens, 8),
                (t, 6, dd.mat16.int(), dd.lens, 8),
                (t, 6, dd.mat16[:, :8].contiguous(), dd.lens, 8),
                (t, 6, dd.mat16, dd.lens[:-1], 8),
                (t, 6, dd.mat16, dd.lens, -1)):
        with pytest.raises(ValueError):
            onpair_decode.decode_tokens(*bad)


# ------------------------------------------------------- decode_stream
@pytest.mark.parametrize("tile", [256, 1024])
def test_decode_stream_matches_reference(dicts, titles, tile):
    comp, jdev, d, _ = dicts
    corpus = comp.compress(titles[:200])
    tokens = np.asarray(corpus.payload.view("<u2"), dtype=np.int32)
    want = jdev.decode_stream(tokens, use_pallas=True, tile=tile)
    port = ops.OnPairDevice(d, CPU)
    assert port.decode_stream(tokens) == want == b"".join(titles[:200])
    assert port.decode_stream(np.zeros(0, np.int32)) == b""


def test_decode_stream_rejects_out_of_range_ids(dicts):
    d = dicts[2]
    port = ops.OnPairDevice(d, CPU)
    calls = ref.decode_tokens_ref.calls
    for bad in ([1, d.num_entries], [-1, 2]):
        with pytest.raises(ValueError):
            port.decode_stream(np.array(bad, np.int32))
    assert ref.decode_tokens_ref.calls == calls


# ------------------------------------------------------------ decode_all
@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_decode_all_matches_reference(dicts, titles, backend):
    comp, _, d, dd = dicts
    strings = titles[:300] + [b"", bytes(range(256)), b"", b"x" * 40]
    corpus = comp.compress(strings)
    want = RefDecoder(comp.to_artifact(), backend=backend).decode_all(corpus)
    for dictionary in (d, dd):
        assert Decoder(dictionary, device=CPU).decode_all(corpus) == want \
            == b"".join(strings)
    assert Decoder(d, device=CPU).dictionary is d
    assert Decoder(dd, device=CPU).dictionary is None
    empty = comp.compress([b"", b""])
    assert Decoder(d, device=CPU).decode_all(empty) == b""


# ------------------------------------------------------------------ scan
@pytest.fixture(scope="module")
def stores(dicts, titles):
    comp, _, d, _ = dicts
    corpus = comp.compress(titles)
    return (CompressedStringStore(d, corpus, device=CPU, strings_per_segment=SEG,
                                  cache_bytes=0),
            RefStore(comp, corpus, backend="numpy", strings_per_segment=SEG))


@pytest.mark.parametrize("lo,hi", [(250, 300), (200, 800), (5, 5), (0, 1),
                                   (256, 512), ("n-3", "n"), (0, "n")])
def test_scan_matches_reference_store(stores, titles, lo, hi):
    port, refstore = stores
    n = len(titles)
    lo, hi = ({"n": n, "n-3": n - 3}.get(x, x) for x in (lo, hi))
    before = port.stats.scan_strings
    got = port.scan(lo, hi)
    assert got == refstore.scan(lo, hi) == titles[lo:hi]
    assert port.stats.scan_strings - before == hi - lo


@pytest.mark.parametrize("lo,hi", [(0, "n+1"), (-1, 3), (10, 9)])
def test_scan_out_of_range_raises(stores, titles, lo, hi):
    port, refstore = stores
    n = len(titles)
    hi = n + 1 if hi == "n+1" else hi
    for store in (port, refstore):
        with pytest.raises(IndexError):
            store.scan(lo, hi)


def test_scan_on_a_converted_store(dicts, titles):
    """A store over bare device tables (no host dictionary) splits the
    decoded stream with the tables' own lengths."""
    comp, _, _, dd = dicts
    corpus = comp.compress(titles[:600])
    store = CompressedStringStore(dd, corpus, device=CPU, strings_per_segment=SEG)
    assert store.scan(0, 600) == titles[:600]
    snap = store.stats_snapshot()
    assert snap["scan_strings"] == 600 and snap["n_tail_strings"] == 0
    assert snap["n_sealed_strings"] == 600
