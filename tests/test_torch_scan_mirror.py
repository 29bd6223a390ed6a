"""The single-pass stream decode over u16 tokens, and the store's scan
straight from its device mirror, against the JAX package, byte for byte:
the plain ``decode_tokens_ref`` on uint16 tokens (whole buffers and slices
starting at any token) against the reference's ``decode_tokens_pallas``
(``decode_gather`` in interpret mode) and the numpy decode; the port's
``scan`` (one stream call for a range's sealed strings, one more for a
writable tail, no token upload) against the reference stores' over the same
ranges, across segments and the sealed/tail boundary, after ``compact()``,
while a background seal commits and split under a small token cap; and
``decode_span``'s check of the host's lengths."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_onpair16, registry
from repro.core.codec import Encoder as RefEncoder
from repro.kernels import onpair_decode as jax_decode
from repro.kernels import ops as jax_ops
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.core.codec import Decoder, Encoder
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import onpair_decode, ops, ref
from repro_torch.store import CompressedStringStore, MutableStringStore
from repro_torch.store import store as store_mod

SAMPLE = 1 << 18
SEG = 256
CPU = torch.device("cpu")
CFG = OnPairConfig.onpair16(sample_bytes=SAMPLE)
JOIN_S = 60.0


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
    return comp, jax_ops.OnPairDevice(comp.dictionary), d, ref.DeviceDict.build(d, CPU)


@pytest.fixture(scope="module")
def stores(dicts, titles):
    comp, _, d, _ = dicts
    corpus = comp.compress(titles)
    return (CompressedStringStore(d, corpus, device=CPU, strings_per_segment=SEG,
                                  cache_bytes=0),
            RefStore(comp, corpus, backend="numpy", strings_per_segment=SEG))


@pytest.fixture(scope="module")
def artifact(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_dict(titles, artifact):
    entries = train_dictionary(titles, CFG).entries
    assert entries == artifact.entries
    return PackedDictionary.build(entries)


def _writable_pair(artifact, port_dict, strings, **kw):
    kw.setdefault("strings_per_segment", 64)
    kw.setdefault("cache_bytes", 0)
    return (MutableStringStore(port_dict, Encoder(port_dict, device=CPU).encode(strings),
                               device=CPU, config=CFG, **kw),
            RefMutable(artifact, RefEncoder(artifact).encode(strings), **kw))


class _StreamCalls:
    """Records the token tensors the stream decode is handed."""

    def __init__(self, monkeypatch):
        self.tokens: list[torch.Tensor] = []
        real = onpair_decode.decode_tokens

        def spy(tokens, *args):
            self.tokens.append(tokens)
            return real(tokens, *args)

        monkeypatch.setattr(onpair_decode, "decode_tokens", spy)


def _is_mirror(tokens: torch.Tensor, store) -> bool:
    """``tokens`` is a view of the store's device mirror (no upload)."""
    mirror, _ = store.resident.on_device()
    return (tokens.dtype == torch.uint16 and tokens.untyped_storage().data_ptr()
            == mirror.untyped_storage().data_ptr())


# ----------------------------------------------- the plain version on u16
@pytest.mark.parametrize("T,offset,cut", [(1, 0, 0), (2047, 0, 0), (2048, 1, 0),
                                          (2049, 3, 0), (5000, 7, 100),
                                          (5000, 5, -41)])
def test_plain_decode_of_u16_tokens_matches_reference(dicts, T, offset, cut):
    """uint16 tokens, from a buffer slice starting ``offset`` tokens in, with
    max_out ``cut`` bytes below (or above) out_len: equal to the reference's
    decode_gather pipeline in interpret mode and to the numpy decode."""
    _, jdev, d, dd = dicts
    rng = np.random.default_rng(T + offset)
    buf = rng.integers(0, d.num_entries, T + offset + 3).astype(np.uint16)
    tokens = torch.from_numpy(buf)[offset : offset + T]
    ids = buf[offset : offset + T].astype(np.int64)
    full = int(d.lens[ids].sum())
    max_out = full - cut
    calls = ref.decode_tokens_ref.calls
    out, out_len = onpair_decode.decode_tokens(tokens, T, dd.mat16, dd.lens, max_out)
    assert ref.decode_tokens_ref.calls == calls + 1     # the CPU runs the plain
    assert out.dtype == torch.uint8 and out.shape == (max_out,)
    assert int(out_len) == full
    want = b"".join(d.entries[t] for t in ids)
    assert out.numpy().tobytes() == (want + bytes(max(-cut, 0)))[:max_out]
    tile = 1024
    padded = np.zeros(-(-T // tile) * tile, np.int32)
    padded[:T] = ids
    jout, jlen = jax_decode.decode_tokens_pallas(
        jnp.asarray(padded), jnp.int32(T), jdev.dd.mat16, jdev.dd.lens, max_out,
        tile=tile)
    assert int(jlen) == full
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout).astype(np.uint8))


def test_plain_decode_of_u16_equals_int32(dicts):
    """The same ids as uint16 and as int32 decode to the same bytes, ids
    above 2**15 included (uint16 is read unsigned)."""
    d, dd = dicts[2], dicts[3]
    ids = np.concatenate([np.arange(d.num_entries - 300, d.num_entries),
                          np.random.default_rng(1).integers(0, d.num_entries, 3000)])
    max_out = int(d.lens[ids].sum()) + 16
    a = onpair_decode.decode_tokens(torch.from_numpy(ids.astype(np.uint16)), ids.size,
                                    dd.mat16, dd.lens, max_out)
    b = onpair_decode.decode_tokens(torch.from_numpy(ids.astype(np.int32)), ids.size,
                                    dd.mat16, dd.lens, max_out)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]) == max_out - 16


def test_plain_decode_with_uint8_lengths(dicts):
    """The store hands the stream decode its entry lengths as uint8: the
    same bytes as with int32 lengths; other length types are refused."""
    d, dd = dicts[2], dicts[3]
    ids = np.random.default_rng(2).integers(0, d.num_entries, 4000)
    tokens = torch.from_numpy(ids.astype(np.uint16))
    max_out = int(d.lens[ids].sum())
    a = onpair_decode.decode_tokens(tokens, ids.size, dd.mat16, dd.lens, max_out)
    b = onpair_decode.decode_tokens(tokens, ids.size, dd.mat16,
                                    dd.lens.to(torch.uint8), max_out)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]) == max_out
    assert ops.OnPairDevice(d, CPU).lens8.dtype == torch.uint8
    for bad in (dd.lens.to(torch.int64), dd.lens.to(torch.int16)):
        with pytest.raises(ValueError):
            onpair_decode.decode_tokens(tokens, 5, dd.mat16, bad, 8)


# --------------------------------------------------- scan from the mirror
def _odd_start(store) -> int:
    """A string with tokens that start at an odd position of the mirror."""
    starts = store.resident.host_starts
    return int(np.flatnonzero((starts[:-1] % 2 == 1) & (np.diff(starts) > 0))[0])


@pytest.mark.parametrize("case", ["across segments", "odd token offset",
                                  "empty", "whole", "one string", "last segment"])
def test_scan_reads_the_mirror_in_one_call(stores, titles, monkeypatch, case):
    port, refstore = stores
    n = len(titles)
    odd = _odd_start(port)
    lo, hi = {"across segments": (200, 3 * SEG + 17), "odd token offset": (odd, odd + 700),
              "empty": (5, 5), "whole": (0, n), "one string": (odd, odd + 1),
              "last segment": (n - SEG - 3, n)}[case]
    spy = _StreamCalls(monkeypatch)
    calls = ref.decode_tokens_ref.calls
    got = port.scan(lo, hi)
    assert got == refstore.scan(lo, hi) == titles[lo:hi]
    n_calls = 0 if lo == hi else 1
    assert ref.decode_tokens_ref.calls - calls == len(spy.tokens) == n_calls
    for tokens in spy.tokens:                  # a view of the mirror, as is
        assert _is_mirror(tokens, port)
        assert tokens.numel() == (port.resident.host_starts[hi]
                                  - port.resident.host_starts[lo])


def _greedy_calls(starts, lo, hi, cap):
    """The calls a scan of [lo, hi) makes under a cap of ``cap`` tokens a
    call: from each call's first string, every next string whose tokens
    still fit, and at least one string."""
    calls, a = [], lo
    while a < hi:
        b = a + 1
        while b < hi and starts[b + 1] - starts[a] <= cap:
            b += 1
        calls.append((a, b))
        a = b
    return calls


@pytest.mark.parametrize("cap", [1, 37, 1000, 4999])
@pytest.mark.parametrize("lo,hi", [(0, None), (201, 1733)])
def test_long_scans_split_by_token_cap(stores, titles, monkeypatch, cap, lo, hi):
    """A scan decodes its sealed strings in calls of at most
    ``_SCAN_MAX_TOKENS`` tokens (a longer string alone), each a view of the
    mirror; the strings equal the reference store's."""
    port, refstore = stores
    hi = len(titles) if hi is None else hi
    monkeypatch.setattr(store_mod, "_SCAN_MAX_TOKENS", cap)
    spy = _StreamCalls(monkeypatch)
    assert port.scan(lo, hi) == refstore.scan(lo, hi) == titles[lo:hi]
    starts = port.resident.host_starts
    # a call over empty strings alone reaches no kernel
    want = [(a, b) for a, b in _greedy_calls(starts, lo, hi, cap) if starts[b] > starts[a]]
    assert len(want) > 1
    assert [t.numel() for t in spy.tokens] == [starts[b] - starts[a] for a, b in want]
    for (a, b), tokens in zip(want, spy.tokens):
        assert _is_mirror(tokens, port)
        assert tokens.numel() <= cap or b == a + 1


def test_long_writable_scan_splits_sealed_part_then_tail(titles, artifact, port_dict,
                                                         monkeypatch):
    """Under a small cap a writable store's scan splits its sealed part and
    still takes one call for the tail."""
    port, refstore = _writable_pair(artifact, port_dict, titles[:256],
                                    async_seal=False)
    for store in (port, refstore):
        store.extend(titles[256:330])
    monkeypatch.setattr(store_mod, "_SCAN_MAX_TOKENS", 500)
    spy = _StreamCalls(monkeypatch)
    assert port.scan(10, 330) == refstore.scan(10, 330) == titles[10:330]
    want = _greedy_calls(port.resident.host_starts, 10, 320, 500)
    assert len(spy.tokens) == len(want) + 1 and len(want) > 1
    assert [_is_mirror(t, port) for t in spy.tokens] == [True] * len(want) + [False]


def test_scan_of_empty_strings_makes_no_call(dicts):
    comp, _, d, _ = dicts
    strings = [b"", b"", b"abc", b"", b""]
    store = CompressedStringStore(d, comp.compress(strings), device=CPU,
                                  strings_per_segment=2)
    calls = ref.decode_tokens_ref.calls
    assert store.scan(0, 2) == [b"", b""] and store.scan(3, 5) == [b"", b""]
    assert ref.decode_tokens_ref.calls == calls
    assert store.scan(0, 5) == strings
    assert ref.decode_tokens_ref.calls == calls + 1


@pytest.mark.parametrize("lo,hi,n_calls", [(100, 325, 2), (300, 330, 2), (321, 330, 1),
                                           (0, 64, 1), (319, 320, 1), (320, 321, 1),
                                           (0, 330, 2)])
def test_writable_scan_is_one_call_sealed_and_one_tail(titles, artifact, port_dict,
                                                       monkeypatch, lo, hi, n_calls):
    """320 sealed strings (the base and one inline seal) and 10 in the tail:
    the sealed part is one call on the mirror, the tail one call on its own
    u16 tokens."""
    port, refstore = _writable_pair(artifact, port_dict, titles[:256],
                                    async_seal=False)
    for store in (port, refstore):
        store.extend(titles[256:330])
    assert (port.n_sealed, port.n_strings) == (320, 330)
    spy = _StreamCalls(monkeypatch)
    calls = ref.decode_tokens_ref.calls
    assert port.scan(lo, hi) == refstore.scan(lo, hi) == titles[lo:hi]
    assert ref.decode_tokens_ref.calls - calls == len(spy.tokens) == n_calls
    sealed_calls = int(lo < 320)
    assert [_is_mirror(t, port) for t in spy.tokens] == \
        [True] * sealed_calls + [False] * (n_calls - sealed_calls)
    assert all(t.dtype == torch.uint16 for t in spy.tokens)


def test_scan_after_compact_matches_reference(titles, artifact, port_dict,
                                              monkeypatch):
    port, refstore = _writable_pair(artifact, port_dict, titles[:500])
    junk = [np.random.default_rng(i).integers(0, 256, 40, dtype=np.uint8).tobytes()
            for i in range(150)]
    for store in (port, refstore):
        store.extend(titles[500:600] + junk)
        store.seal_barrier()
    want = titles[:600] + junk
    got, ref_got = port.compact(), refstore.compact()
    assert got["ratio_after"] == ref_got["ratio_after"]
    spy = _StreamCalls(monkeypatch)
    for lo, hi in ((0, 750), (63, 65), (599, 700), (701, 750)):
        assert port.scan(lo, hi) == refstore.scan(lo, hi) == want[lo:hi]
    assert len(spy.tokens) == 4 and all(_is_mirror(t, port) for t in spy.tokens)


def test_scan_while_a_background_seal_commits(titles, artifact, port_dict,
                                              monkeypatch):
    """A scan while the seal worker builds its segment reads the strings
    from the tail (two calls), one after the commit from the mirror (one);
    both equal the reference store's."""
    port, refstore = _writable_pair(artifact, port_dict, titles[:128])
    building, release = threading.Event(), threading.Event()
    build = MutableStringStore._build_segment

    def slow_build(parts):
        building.set()
        release.wait(JOIN_S)
        return build(parts)

    monkeypatch.setattr(port, "_build_segment", slow_build)
    for store in (port, refstore):
        store.extend(titles[128:200])          # 72 in the tail: one seal
    try:
        assert building.wait(JOIN_S)
        assert port.n_sealed == 128            # the seal has not committed
        calls = ref.decode_tokens_ref.calls
        assert port.scan(100, 200) == titles[100:200]
        assert ref.decode_tokens_ref.calls - calls == 2
    finally:
        release.set()
    port.seal_barrier()
    refstore.seal_barrier()
    assert port.n_sealed == 192
    calls = ref.decode_tokens_ref.calls
    assert port.scan(100, 190) == refstore.scan(100, 190) == titles[100:190]
    assert ref.decode_tokens_ref.calls - calls == 1
    assert port.scan(0, 200) == refstore.scan(0, 200) == titles[:200]


# ------------------------------------------------------------ decode_span
def test_decode_span_splits_by_host_lengths_and_checks_them(dicts, titles):
    comp, _, d, _ = dicts
    corpus = comp.compress(titles[:50])
    dev = ops.OnPairDevice(d, CPU)
    tokens = torch.from_numpy(corpus.payload.view("<u2").copy())
    lens = np.fromiter(map(len, titles[:50]), np.int64)
    calls = ref.decode_tokens_ref.calls
    assert dev.decode_span(tokens, lens) == titles[:50]
    for bad in (lens + np.eye(1, 50, 7, dtype=np.int64)[0], lens[:-1],
                np.concatenate((lens[:10], [lens[10] - 1], lens[11:]))):
        with pytest.raises(ValueError):
            dev.decode_span(tokens, bad)
    with pytest.raises(ValueError):        # no tokens, but bytes expected
        dev.decode_span(tokens[:0], [3])
    with pytest.raises(ValueError):        # tokens, but no bytes expected
        dev.decode_span(tokens[:5], [0])
    assert dev.decode_span(tokens[:0], [0, 0]) == [b"", b""]
    assert ref.decode_tokens_ref.calls == calls + 6


def test_decode_all_hands_the_kernel_u16_tokens(dicts, titles, monkeypatch):
    comp, _, d, _ = dicts
    corpus = comp.compress(titles[:400])
    spy = _StreamCalls(monkeypatch)
    assert Decoder(d, device=CPU).decode_all(corpus) == b"".join(titles[:400])
    assert [t.dtype for t in spy.tokens] == [torch.uint16]
    port = ops.OnPairDevice(d, CPU)
    bad_ids = [np.array([1, d.num_entries]), np.array([-1, 2], np.int32)]
    if d.num_entries < 1 << 16:
        bad_ids.append(np.array([1, d.num_entries], np.uint16))
    for bad in bad_ids:
        with pytest.raises(ValueError):
            port.decode_stream(bad)
    assert len(spy.tokens) == 1
