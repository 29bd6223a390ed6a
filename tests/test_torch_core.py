"""repro_torch core vs the JAX package's: synthetic data, OnPair16 training,
the frozen dictionary's arrays and the hash/ctz/shared-prefix primitives —
all exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_fallback import given, settings, st

from repro.core import make_onpair16
from repro.core import onpair as ref_onpair
from repro.core import packed as ref_packed
from repro.core.packing import pack_u64, shared_prefix_size
from repro.data import synth as ref_synth
from repro.kernels import ref as jax_ref
from repro_torch.core.lpm import lpm_from_entries
from repro_torch.core.onpair import OnPairConfig, auto_threshold, train_dictionary
from repro_torch.core.packed import PackedDictionary, hash_key, mix32, split_u64
from repro_torch.data import synth
from repro_torch.kernels import ref

SAMPLE = 1 << 19
U32_EDGES = [0, 1, 2, 0x80, 0xFF, 0x100, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
             0xFFFFFFFF]


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
    return synth.load_dataset("book_titles", SAMPLE)


@pytest.fixture(scope="module")
def trained(titles):
    comp = make_onpair16(sample_bytes=SAMPLE, seed=7)
    comp.train(titles)
    port = train_dictionary(titles, OnPairConfig.onpair16(sample_bytes=SAMPLE,
                                                          seed=7))
    return comp, port


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("name,seed", [(name, None) for name in
                                       sorted(ref_synth.DATASETS)]
                         + [("book_titles", 5), ("urls", 9)])
def test_synth_matches_reference(name, seed):
    assert (synth.load_dataset(name, 1 << 15, seed=seed)
            == ref_synth.load_dataset(name, 1 << 15, seed=seed))


# -------------------------------------------------------------- training
def test_train_dictionary_matches_reference(trained):
    comp, port = trained
    ref_result = comp.train_result
    assert port.entries == ref_result.entries
    assert len(port.entries) > 256  # the sample really merged pairs
    for k in ("scanned_bytes", "scanned_strings", "threshold",
              "merges_attempted", "merges_accepted"):
        assert getattr(port, k) == getattr(ref_result, k), k


@pytest.mark.parametrize("nbytes", [0, 1 << 20, (1 << 20) + 1, 3 << 20,
                                    5 << 23, 1 << 30])
def test_auto_threshold_matches_reference(nbytes):
    assert auto_threshold(nbytes) == ref_onpair.auto_threshold(nbytes)


def test_train_bounds_and_small_max_tokens(titles):
    """OnPair16 bounds hold, and a small max_tokens stops training exactly
    where the reference does."""
    cfg = OnPairConfig.onpair16(sample_bytes=1 << 16, seed=3, max_tokens=300)
    port = train_dictionary(titles, cfg)
    comp = make_onpair16(sample_bytes=1 << 16, seed=3, max_tokens=300)
    comp.train(titles)
    assert port.entries == comp.dictionary.entries
    assert len(port.entries) == 300
    assert max(map(len, port.entries)) <= 16


def test_training_lpm_parse_matches_reference(trained, titles):
    comp, port = trained
    lpm = lpm_from_entries(port.entries)
    for s in titles[:200] + [b"", bytes(range(256)), b"x" * 40]:
        assert lpm.parse(s) == list(
            np.frombuffer(comp.compress_string(s), dtype="<u2"))


# --------------------------------------------------------- frozen arrays
PACKED_FIELDS = [f.name for f in dataclasses.fields(PackedDictionary)]


@pytest.mark.parametrize("field", PACKED_FIELDS)
def test_packed_dictionary_matches_reference(trained, field):
    comp, port = trained
    got = getattr(PackedDictionary.build(port.entries), field)
    want = getattr(comp.dictionary, field)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_packed_accounting_matches_reference(trained):
    comp, port = trained
    d = PackedDictionary.build(port.entries)
    assert d.num_entries == comp.dictionary.num_entries
    assert d.data_bytes == comp.dictionary.data_bytes
    assert d.total_bytes == comp.dictionary.total_bytes
    assert d.resident_bytes == comp.dictionary.resident_bytes


def test_device_dict_holds_reference_bits(trained):
    """The int32 tensors hold exactly the reference's u32 table bits."""
    comp, port = trained
    dd = ref.DeviceDict.build(PackedDictionary.build(port.entries),
                              torch.device("cpu"))
    jdd = jax_ref.DeviceDict.build(comp.dictionary)
    for name in ref.ARRAY_FIELDS:
        got = getattr(dd, name).numpy()
        want = np.asarray(getattr(jdd, name))
        np.testing.assert_array_equal(got.view(want.dtype) if got.dtype.itemsize
                                      == want.dtype.itemsize else got, want,
                                      err_msg=name)
    assert (dd.s_probe_max, dd.p_probe_max, dd.max_bucket) == (
        jdd.s_probe_max, jdd.p_probe_max, jdd.max_bucket)


def test_device_dict_rejects_malformed_tables(trained):
    _, port = trained
    d = PackedDictionary.build(port.entries)
    arrays = {k: getattr(d, k) for k in ref.ARRAY_FIELDS}
    kw = dict(s_probe_max=d.s_probe_max, p_probe_max=d.p_probe_max,
              max_bucket=d.max_bucket_size, device=torch.device("cpu"))
    for bad in ({"lens": np.full_like(d.lens, 17)},
                {"mat16": d.mat16[:, :8]},
                {"s_lo": d.s_lo[:-1]}):
        with pytest.raises(ValueError):
            ref.DeviceDict.from_arrays({**arrays, **bad}, **kw)
    with pytest.raises(ValueError):
        ref.DeviceDict.from_arrays({k: v for k, v in arrays.items()
                                    if k != "suf_tok"}, **kw)


# ------------------------------------------------------------ primitives
def _t(*xs):
    return [torch.tensor([x], dtype=torch.int64) for x in xs]


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=200, deadline=None, database=None)
def test_mix32_matches_reference(x):
    want = ref_packed.mix32(x)
    assert mix32(x) == want
    assert int(ref.mix32(*_t(x))) == want
    assert int(jax_ref.mix32(jnp.uint32(x))) == want


@given(st.integers(0, 2**64 - 1), st.integers(0, 16))
@settings(max_examples=200, deadline=None, database=None)
def test_hash_key_matches_reference(v, length):
    lo, hi = split_u64(v)
    want = ref_packed.hash_key(lo, hi, length)
    assert hash_key(lo, hi, length) == want
    assert int(ref.hash_key(*_t(lo, hi, length))) == want


@pytest.mark.parametrize("lo", U32_EDGES)
@pytest.mark.parametrize("hi", [0, 0xFFFFFFFF, 0x12345678])
def test_hash_key_boundaries(lo, hi):
    for length in (0, 1, 8, 16):
        want = ref_packed.hash_key(lo, hi, length)
        assert int(ref.hash_key(*_t(lo, hi, length))) == want
        assert int(jax_ref.hash_key(jnp.uint32(lo), jnp.uint32(hi),
                                    jnp.int32(length))) == want


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=200, deadline=None, database=None)
def test_ctz32_matches_reference(x):
    want = 32 if x == 0 else (x & -x).bit_length() - 1
    assert int(ref.ctz32(*_t(x))) == want == int(jax_ref.ctz32(jnp.uint32(x)))


def test_ctz32_boundaries():
    xs = U32_EDGES + [1 << k for k in range(32)]
    got = ref.ctz32(torch.tensor(xs, dtype=torch.int64)).tolist()
    want = [int(jax_ref.ctz32(jnp.uint32(x))) for x in xs]
    assert got == want


@given(st.binary(min_size=0, max_size=8), st.binary(min_size=0, max_size=8))
@settings(max_examples=200, deadline=None, database=None)
def test_shared_prefix_bytes_matches_reference(a, b):
    va, vb = pack_u64(a, 0, len(a)), pack_u64(b, 0, len(b))
    want = min(shared_prefix_size(va, vb), 8)
    (lo_a, hi_a), (lo_b, hi_b) = split_u64(va), split_u64(vb)
    assert int(ref.shared_prefix_bytes(*_t(lo_a, hi_a, lo_b, hi_b))) == want
    assert int(jax_ref.shared_prefix_bytes(
        jnp.uint32(lo_a), jnp.uint32(hi_a), jnp.uint32(lo_b),
        jnp.uint32(hi_b))) == want
