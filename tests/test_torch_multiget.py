"""The multiget decode in repro_torch against the JAX package, exactly: the
ragged plain version ``decode_rows_ref`` (what the rows kernel computes)
against the reference's ``decode_compact`` in interpret mode on the same
strings padded, row for row; the device mirror of the sealed segments after
build, background seals and ``compact()``; and the stores' multiget answers,
stats and cache counters against the reference's JAX-backend stores after
the same calls, with one launch per call (two when the tail is touched)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_onpair16, registry
from repro.core.codec import Encoder as RefEncoder
from repro.kernels import onpair_decode as jax_decode
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.core.codec import Decoder, Encoder
from repro_torch.core.onpair import OnPairConfig
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import onpair_decode, ops, ref
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 18
SEG = 256
CPU = torch.device("cpu")
CFG = OnPairConfig.onpair16(sample_bytes=SAMPLE)
#: snapshot keys that hold counts (the rest are timings or sizes)
COUNTED = ("lookups", "decoded_strings", "decoded_bytes", "scan_strings",
           "batches", "padded_rows", "pad_efficiency", "jit_shapes", "cache")


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
    strings[11] = bytes(range(256))                  # 248 tokens
    strings[12] = b" / ".join(strings[20:30])        # past one lane group
    return strings


@pytest.fixture(scope="module")
def comp(titles):
    c = make_onpair16(sample_bytes=SAMPLE, seed=7)
    c.train(titles)
    return c, c.compress(titles)


@pytest.fixture(scope="module")
def tables(comp):
    """(reference jnp DeviceDict, port DeviceDict on the CPU), one dictionary."""
    c, _ = comp
    d = PackedDictionary.build(c.dictionary.entries)
    return jax_ref.DeviceDict.build(c.dictionary), ref.DeviceDict.build(d, CPU)


def _rows_vs_reference(tables, token_lists, ids, lens=None, tok_dtype=np.uint16):
    """Strings ``token_lists`` back to back as one buffer, rows ``ids`` of it
    through ``decode_rows_ref`` into ranges sized by the true lengths; the
    same rows padded through the reference's Pallas ``decode_compact``
    (interpret). ``lens`` (default: the true table) is the table both
    decode with. Asserts out_len equal and each row's range equal to the
    reference row's first bytes; returns (out, out_len, ranges)."""
    jdd, dd = tables
    lens = dd.lens.numpy() if lens is None else lens
    true = dd.lens.numpy().astype(np.int64)
    counts = np.asarray([t.size for t in token_lists], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)))
    flat = np.concatenate(token_lists + [np.zeros(0, np.int64)]).astype(tok_dtype)
    ids = np.asarray(ids, dtype=np.int64)
    raw = np.asarray([int(true[token_lists[i]].sum()) for i in ids], dtype=np.int64)
    off = np.concatenate(([0], np.cumsum(raw)))
    out, olen = ref.decode_rows_ref(
        torch.from_numpy(flat), torch.from_numpy(starts), torch.from_numpy(off),
        int(off[-1]), dd.mat16, torch.from_numpy(lens.astype(np.int32)),
        ids=torch.from_numpy(ids))
    assert out.shape == (int(off[-1]),) and olen.shape == (ids.size,)
    if ids.size:
        T = max(8, int(counts[ids].max()))
        padded, n = jax_ops.pack_token_matrix([token_lists[i] for i in ids],
                                              pad_tokens=T)
        jout, jlen = jax_decode.decode_compact(
            jnp.asarray(padded), jnp.asarray(n), jdd.mat16,
            jnp.asarray(lens.astype(np.int32)), 16 * T)
        jout, jlen = np.asarray(jout).astype(np.uint8), np.asarray(jlen)
        np.testing.assert_array_equal(olen.numpy(), jlen)
        got = out.numpy()
        for m in range(ids.size):
            k = min(int(raw[m]), int(jlen[m]))
            assert got[off[m] : off[m] + k].tobytes() == jout[m, :k].tobytes()
    return out, olen, off


@pytest.mark.parametrize("tok_dtype", [np.uint16, np.int32])
def test_rows_plain_version_matches_reference_compact(comp, tables, titles,
                                                      tok_dtype):
    """Corpus strings, rows picked by id (duplicates and 0-token rows among
    them, rows of 248 and of 20-odd tokens, past the 8-lane group), every byte of
    every row's range."""
    c, corpus = comp
    lists = [np.asarray(corpus.string_tokens(i), np.int64) for i in range(400)]
    ids = np.random.default_rng(3).integers(0, 400, 300).tolist() + [3, 3, 11, 12, 0]
    assert lists[3].size == 0 and lists[11].size > 8 and lists[12].size > 16
    out, olen, off = _rows_vs_reference(tables, lists, ids, tok_dtype=tok_dtype)
    got = out.numpy().tobytes()
    assert [got[off[m] : off[m + 1]] for m in range(len(ids))] == \
        [titles[i] for i in ids]


def test_rows_of_sixteen_byte_entries_and_empty_rows(tables):
    lens = tables[1].lens.numpy()
    sixteen = np.flatnonzero(lens == 16)
    assert sixteen.size >= 20
    lists = [sixteen[:20], np.zeros(0, np.int64), sixteen[3:4], sixteen[:9],
             np.zeros(0, np.int64)]
    _, olen, _ = _rows_vs_reference(tables, lists, [0, 1, 2, 3, 4, 1, 0])
    assert olen.tolist() == [320, 0, 16, 144, 0, 0, 320]


def test_rows_with_no_rows(tables):
    jdd, dd = tables
    out, olen = ref.decode_rows_ref(
        torch.zeros(0, dtype=torch.uint16), torch.zeros(1, dtype=torch.int64),
        torch.zeros(1, dtype=torch.int64), 0, dd.mat16, dd.lens,
        ids=torch.zeros(0, dtype=torch.int64))
    assert out.shape == (0,) and olen.shape == (0,)
    out, olen = onpair_decode.decode_rows(            # the wrapper, M = 0
        torch.zeros(5, dtype=torch.int32), torch.zeros(1, dtype=torch.int64),
        torch.zeros(1, dtype=torch.int64), 0, dd.mat16, dd.lens)
    assert out.shape == (0,) and olen.shape == (0,)


def test_rows_under_a_lying_length_table_stay_in_their_ranges(comp, tables):
    """Ranges sized by the true lengths, decode with a table whose lengths
    lie (still 1..16): each row keeps to its range (a write past the last
    range would fail the plain version's scatter), holds the first bytes of
    the reference's decode under the same lie, and out_len reports the
    lying total, which differs from the range."""
    _, corpus = comp
    lists = [np.asarray(corpus.string_tokens(i), np.int64) for i in range(60)]
    lie = np.random.default_rng(5).integers(1, 17, tables[1].lens.numel())
    ids = list(range(60))
    _, olen, off = _rows_vs_reference(tables, lists, ids, lens=lie)
    longer = olen.numpy() > np.diff(off)
    assert longer.any() and (olen.numpy() < np.diff(off)).any()
    # an overflowing row last, then before an empty row: a write past its
    # range would land past the output; and every byte of a range past its
    # own row's bytes is still zero, not a neighbour's
    ids = [int(np.flatnonzero(~longer)[0]), int(np.flatnonzero(longer)[0]), 3]
    out, olen, off = _rows_vs_reference(tables, lists, ids, lens=lie)
    assert olen[1] > off[2] - off[1] and off[3] == off[2]
    keep = np.minimum(np.diff(off), olen.numpy())
    assert not any(out.numpy()[off[m] + keep[m] : off[m + 1]].any() for m in range(3))


def test_rows_never_write_outside_the_output(tables):
    """Output offsets past the buffer's end or before its start drop the
    bytes that would land outside it; rows inside it decode as ever."""
    dd = tables[1]
    sixteen = np.flatnonzero(dd.lens.numpy() == 16)[:3]
    tok = torch.from_numpy(np.concatenate((sixteen, sixteen)).astype(np.int32))
    starts = torch.tensor([0, 3, 6, 6])
    full, olen = ref.decode_rows_ref(tok, starts, torch.tensor([0, 48, 96, 96]),
                                     96, dd.mat16, dd.lens)
    cut, clen = ref.decode_rows_ref(tok, starts, torch.tensor([0, 48, 96, 96]),
                                    60, dd.mat16, dd.lens)
    assert torch.equal(cut, full[:60]) and torch.equal(clen, olen)
    moved, _ = ref.decode_rows_ref(tok, starts, torch.tensor([-8, 40, 96, 96]),
                                   96, dd.mat16, dd.lens)
    assert not moved[:40].any() and torch.equal(moved[40:88], full[48:])


def test_rows_ids_without_a_string_decode_to_nothing(tables):
    """A row id outside [0, starts.numel() - 1) is a row of no tokens: it
    writes nothing and reports length 0, and the rows around it decode as
    they would alone (the kernel reads no start for it)."""
    dd = tables[1]
    sixteen = np.flatnonzero(dd.lens.numpy() == 16)[:4]
    tok = torch.from_numpy(sixteen.astype(np.int32))
    starts = torch.tensor([0, 2, 4])
    off = torch.tensor([0, 32, 48, 64, 80, 112])
    out, olen = onpair_decode.decode_rows(
        tok, starts, off, 112, dd.mat16, dd.lens,
        ids=torch.tensor([0, -1, 2, 3, 1]))
    assert olen.tolist() == [32, 0, 0, 0, 32]
    want, _ = onpair_decode.decode_rows(tok, starts, torch.tensor([0, 32, 64]),
                                        64, dd.mat16, dd.lens)
    assert torch.equal(out[:32], want[:32]) and torch.equal(out[80:], want[32:])
    assert not out[32:80].any()
    for S in (0, 1):                     # no string at all
        out, olen = onpair_decode.decode_rows(
            tok, starts[:S], torch.tensor([0, 16]), 16, dd.mat16, dd.lens,
            ids=torch.tensor([0]))
        assert olen.tolist() == [0] and not out.any()


def test_rows_wrapper_checks_inputs(tables):
    dd = tables[1]
    t = torch.zeros(4, dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int64)
    o = torch.zeros(3, dtype=torch.int64)
    for bad in ((t.long(), s, o), (t, s.int(), o), (t, s, o.int()),
                (t.reshape(2, 2), s, o), (t, s[:1], o)):
        with pytest.raises(ValueError):
            onpair_decode.decode_rows(*bad, 0, dd.mat16, dd.lens)
    with pytest.raises(ValueError):  # ids of the wrong length
        onpair_decode.decode_rows(t, s, o, 0, dd.mat16, dd.lens,
                                  ids=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        onpair_decode.decode_rows(t, s, o, -1, dd.mat16, dd.lens)
    calls, launches = ref.decode_rows_ref.calls, onpair_decode.decode_compact.launches
    onpair_decode.decode_rows(t, s, o, 0, dd.mat16, dd.lens)
    assert ref.decode_rows_ref.calls == calls + 1      # the CPU runs the plain
    assert onpair_decode.decode_compact.launches == launches


# ------------------------------------------------------------- the stores
def _mirror_is_the_segments(store):
    """The device mirror holds exactly the sealed segments: tokens, starts
    and each string's decoded length."""
    res = store.resident
    assert res.n_strings == store.n_sealed
    segs = store.segments.segments
    toks = np.concatenate([s.tokens() for s in segs] + [np.zeros(0, "<u2")])
    tokens, starts = res.on_device()
    np.testing.assert_array_equal(tokens.numpy(), toks)
    counts = store.segments.token_counts()
    np.testing.assert_array_equal(np.diff(res.host_starts), counts)
    np.testing.assert_array_equal(starts[: res.n_strings + 1].numpy(),
                                  res.host_starts)
    lens = store._device.host_lens
    cum = np.concatenate(([0], np.cumsum(lens[toks.astype(np.int64)])))
    np.testing.assert_array_equal(res.raw_lens, np.diff(cum[res.host_starts]))
    assert store.resident_device_bytes >= toks.nbytes + 8 * (res.n_strings + 1)


def _counted(snap):
    return {k: snap[k] for k in COUNTED}


@pytest.mark.parametrize("cache_bytes", [0, 1 << 11, 8 << 20])
def test_stats_and_cache_equal_reference_jax_store(comp, titles, cache_bytes):
    c, corpus = comp
    kw = dict(strings_per_segment=SEG, cache_bytes=cache_bytes)
    store = CompressedStringStore(PackedDictionary.build(c.dictionary.entries),
                                  corpus, device="cpu", **kw)
    want = RefStore(c, corpus, backend="jax", **kw)
    rng = np.random.default_rng(cache_bytes)
    n = len(titles)
    short = np.flatnonzero(corpus.token_counts() <= 8)[-2 * SEG :]
    for ids in (rng.integers(0, n, 300).tolist() + [11, 12, 3, 11],
                rng.integers(0, 40, 120).tolist(), [12], [],
                short.tolist()):                  # exactly two batches' worth
        assert store.multiget(ids) == want.multiget(ids) == [titles[i] for i in ids]
    assert _counted(store.stats_snapshot()) == _counted(want.stats_snapshot())
    _mirror_is_the_segments(store)


def test_one_launch_per_multiget(comp, titles, monkeypatch):
    """Every miss of a call decodes in one launch; a call of more misses
    than a launch takes goes up in launches of _DECODE_MAX_ROWS; a call of
    hits only launches nothing."""
    c, corpus = comp
    store = CompressedStringStore(PackedDictionary.build(c.dictionary.entries),
                                  corpus, device="cpu", strings_per_segment=SEG,
                                  cache_bytes=1 << 20)
    n = len(titles)
    ids = list(range(0, n, 3))
    calls = ref.decode_rows_ref.calls
    assert store.multiget(ids) == [titles[i] for i in ids]
    assert ref.decode_rows_ref.calls == calls + 1
    assert store.multiget(ids[:50]) == [titles[i] for i in ids[:50]]  # cached
    assert ref.decode_rows_ref.calls == calls + 1
    monkeypatch.setattr(ops, "_DECODE_MAX_ROWS", 64)
    more = list(range(1, 1 + 64 * 3, 3)) + [2]        # 65 misses
    assert store.multiget(np.asarray(more)) == [titles[i] for i in more]
    assert ref.decode_rows_ref.calls == calls + 3


def test_multiget_id_forms(comp, titles):
    c, corpus = comp
    store = CompressedStringStore(PackedDictionary.build(c.dictionary.entries),
                                  corpus, device="cpu", strings_per_segment=SEG,
                                  cache_bytes=0)
    want = [titles[i] for i in (5, 2, 5)]
    for ids in ([5, 2, 5], (5, 2, 5), np.array([5, 2, 5], np.uint16),
                (i for i in (5, 2, 5)), [np.int64(5), 2, np.int32(5)]):
        assert store.multiget(ids) == want
    assert store.multiget(range(3)) == titles[:3]
    with pytest.raises(IndexError):
        store.multiget(np.array([0, len(titles)]))


def test_writable_mirror_and_launches_match_reference(titles):
    """The mirror after build, after background seals and after compact();
    every sealed id's multiget equals the reference store's; stats and cache
    counters equal the reference's JAX-backend store's; one launch per call
    without a tail, two with one."""
    artifact = registry.train("onpair16", titles, sample_bytes=SAMPLE)
    d = PackedDictionary.build(artifact.entries)
    base = titles[:700]
    kw = dict(strings_per_segment=SEG, cache_bytes=1 << 12)
    port = MutableStringStore(d, Encoder(d, device=CPU).encode(base), device=CPU,
                              config=CFG, **kw)
    want = RefMutable(artifact, RefEncoder(artifact).encode(base), backend="jax",
                      **kw)
    _mirror_is_the_segments(port)

    def same(ids, launches):
        calls = ref.decode_rows_ref.calls
        assert port.multiget(ids) == want.multiget(ids)
        assert ref.decode_rows_ref.calls - calls == launches

    rng = np.random.default_rng(1)
    same(rng.integers(0, 700, 200).tolist(), 1)
    for store in (port, want):
        for lo in range(700, 1400, 100):              # seals run off-thread
            store.extend(titles[lo : lo + 100])
        store.seal_barrier()
    assert port.n_sealed == want.n_sealed == 700 + 2 * SEG  # tail: 188
    _mirror_is_the_segments(port)
    same(list(range(port.n_sealed)), 1)                # every sealed id
    same([0, 1300, 1301, 5, 1399], 2)                  # sealed and tail
    same([1398, 1250], 1)                              # the tail alone
    same([0, 1399], 0)                                 # cached now
    assert _counted(port.stats_snapshot()) == _counted(want.stats_snapshot())
    for store in (port, want):
        store.compact()
    _mirror_is_the_segments(port)
    assert port.n_sealed == 1400
    same(list(range(1400)), 1)
    assert _counted(port.stats_snapshot()) == _counted(want.stats_snapshot())


def test_decoder_multiget_is_one_launch(comp, titles):
    c, corpus = comp
    dec = Decoder(PackedDictionary.build(c.dictionary.entries), device="cpu")
    ids = [11, 0, 3, 12, 11, 400]
    calls = ref.decode_rows_ref.calls
    assert dec.multiget(corpus, ids) == [titles[i] for i in ids]
    assert ref.decode_rows_ref.calls == calls + 1
