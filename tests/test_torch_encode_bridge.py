"""The encode bridge and the encode parse's corner cases against the JAX
package: vectorised packing against the reference's ``pack_strings``,
chunked bucketed encode against the reference's host parse, and the crafted
tables of ``repro_torch.kernels.crafted`` through the port's plain version
and the reference's ``encode_batch_pallas`` (interpret mode) — all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_onpair16
from repro.kernels import onpair_encode as jax_encode
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.codec import Encoder
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import crafted, ops, ref

SAMPLE = 1 << 18
CPU = torch.device("cpu")


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
    return load_dataset("book_titles", SAMPLE)


@pytest.fixture(scope="module")
def comp(titles):
    c = make_onpair16(sample_bytes=SAMPLE, seed=3)
    c.train(titles)
    return c


@pytest.fixture(scope="module")
def case():
    return crafted.encode_case(seed=0, n_mixed=300)


# --------------------------------------------------------------- packing
PACK_CASES = {
    "empty strings": ([b"", b"", b"a", b""], 32),
    "exactly cap": ([b"x" * 32, b"", b"y" * 31, b"z" * 32], 32),
    "a new cap (past 512)": ([b"q" * 700, b"ab", b"r" * 1024], 1024),
    "one string": ([b"hello"], 8),
    "no strings": ([], 32),
    "binary": ([bytes(range(256)), b"\x00" * 20, b"\xff"], 256),
}


@pytest.mark.parametrize("name", sorted(PACK_CASES))
@pytest.mark.parametrize("pad", ["cap", "none"])
def test_vectorised_packing_equals_reference(name, pad):
    strings, cap = PACK_CASES[name]
    kw = {"pad_len": cap} if pad == "cap" else {}
    got = ops.pack_strings(strings, **kw)
    want = jax_ops.pack_strings(strings, **kw)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32  # the
    # reference holds bytes as int32 values; the port as bytes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_packing_rejects_a_string_longer_than_pad_len():
    """The reference writes such a string into the row's padding; the port
    refuses it, naming the first one."""
    with pytest.raises(ValueError, match="string 1 has 9 bytes > pad_len=8"):
        ops.pack_strings([b"a", b"b" * 9, b"c" * 20], pad_len=8)


def test_encode_cap_growth_is_by_doubling(comp):
    dev = ops.OnPairDevice(PackedDictionary.build(comp.dictionary.entries), CPU)
    dev.encode_flat([b"w" * 3000, b"a"])
    assert dev.encode_len_caps == [32, 128, 512, 1024, 2048, 4096]


# --------------------------------------------------------- chunked encode
@pytest.mark.parametrize("chunk", [1, 3, 4, 64])
def test_bucketed_encode_across_chunks_equals_reference_parse(comp, titles, chunk):
    """10 strings over three length caps in chunks of ``chunk`` strings:
    every chunk is one launch, and the streams come back in input order."""
    strings = [titles[0], b"", b"z" * 40, titles[5] * 3, b"q" * 600, titles[9],
               b"a", titles[11] + titles[12], b"", bytes(range(256))]
    dev = ops.OnPairDevice(PackedDictionary.build(comp.dictionary.entries), CPU)
    dev.encode_pad_batch = chunk
    launches = ref.encode_batch_ref.calls
    got = dev.encode_to_bytes(strings)
    assert got == [comp.compress_string(s) for s in strings]
    caps = [dev._encode_cap(max(len(s), 1)) for s in strings]
    assert ref.encode_batch_ref.calls - launches == sum(
        -(-caps.count(c) // chunk) for c in set(caps))
    tokens, counts = dev.encode_flat(strings)
    assert tokens.dtype == np.int32 and counts.tolist() == [len(g) // 2 for g in got]
    assert tokens.astype("<u2").tobytes() == b"".join(got)


def test_long_strings_chunk_by_padded_bytes(comp, titles, monkeypatch):
    """A chunk also holds at most ``_ENCODE_CHUNK_BYTES`` padded bytes, so a
    group of long strings goes up in smaller chunks than the short ones; by
    default the main path's caps (up to 512) still take full chunks."""
    assert ops._ENCODE_CHUNK_BYTES // (512 + 16) >= ops._ENCODE_PAD_BATCH
    strings = titles[:6] + [b"q" * 600 + titles[i] for i in range(5)]
    dev = ops.OnPairDevice(PackedDictionary.build(comp.dictionary.entries), CPU)
    monkeypatch.setattr(ops, "_ENCODE_CHUNK_BYTES", 2 * (1024 + 16))  # cap 1024:
    # two strings a chunk
    launches = ref.encode_batch_ref.calls
    got = dev.encode_to_bytes(strings)
    assert got == [comp.compress_string(s) for s in strings]
    caps = [dev._encode_cap(max(len(s), 1)) for s in strings]
    assert caps.count(1024) == 5
    per_chunk = {c: min(dev.encode_pad_batch, ops._ENCODE_CHUNK_BYTES // (c + 16))
                 for c in set(caps)}
    assert per_chunk[1024] == 2 and all(per_chunk[c] >= 6 for c in per_chunk if c < 1024)
    assert ref.encode_batch_ref.calls - launches == sum(
        -(-caps.count(c) // per_chunk[c]) for c in set(caps))


def test_encoder_in_small_chunks_equals_reference_corpus(comp, titles):
    strings = titles[:200] + [b"", b"y" * 700]
    enc = Encoder(PackedDictionary.build(comp.dictionary.entries), device=CPU)
    enc._device.encode_pad_batch = 7
    got, want = enc.encode(strings), comp.compress(strings)
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    empty = enc.encode([])
    assert empty.payload.size == 0 and empty.offsets.tolist() == [0]


# ------------------------------------------------------- crafted tables
def _jax_dict(case):
    a = case.arrays
    return jax_ref.DeviceDict(
        mat16=jnp.asarray(a["mat16"].astype(np.int32)),
        lens=jnp.asarray(a["lens"]),
        **{k: jnp.asarray(a[k]) for k in ref.ARRAY_FIELDS if k not in ("mat16", "lens")},
        s_probe_max=case.s_probe_max, p_probe_max=case.p_probe_max,
        max_bucket=case.max_bucket)


def _port_dict(case):
    return ref.DeviceDict.from_arrays(case.arrays, s_probe_max=case.s_probe_max,
                                      p_probe_max=case.p_probe_max,
                                      max_bucket=case.max_bucket, device=CPU)


def _both(case, strings, pad_len, max_tokens, jax_fn):
    data, lens = ops.pack_strings(strings, pad_len=pad_len)
    toks, n = ref.encode_batch_ref(torch.from_numpy(data), torch.from_numpy(lens),
                                   _port_dict(case), max_tokens)
    jt, jn = jax_fn(jnp.asarray(data.astype(np.int32)), jnp.asarray(lens),
                    _jax_dict(case), max_tokens)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    return toks.numpy(), n.numpy()


def test_crafted_cases_match_reference_kernel(case):
    """Each named case through the port's plain version and the reference's
    Pallas kernel (interpret mode): equal tokens, and the first token is the
    one the case was built for."""
    named = [c for c in case.cases if c[0] != "mixed"]
    assert len(named) >= 30
    toks, n = _both(case, [s for _, s, _ in named], 48, 48,
                    jax_encode.encode_batch_pallas)
    mat, lens = case.arrays["mat16"], case.arrays["lens"]
    for i, (name, s, first) in enumerate(named):
        row = toks[i, : n[i]].tolist()
        assert (row[0] if row else -1) == first, name
        if crafted.MISSING[0] not in s:  # no fallback: the parse decodes back
            assert b"".join(mat[t, : lens[t]].tobytes() for t in row) == s, name


@pytest.mark.parametrize("pad_len,max_tokens", [(200, 200), (201, 7), (203, 1)])
def test_crafted_mixed_strings_match_reference(case, pad_len, max_tokens):
    """The mixed strings at an aligned and two unaligned row widths, with
    and without max_tokens truncation, against the reference's jitted
    oracle (the Pallas kernel runs the same search, tested above)."""
    strings = [s for name, s, _ in case.cases if name == "mixed"]
    _, n = _both(case, strings, pad_len, max_tokens, jax_ref.encode_batch_ref_jit)
    assert n.max() == max_tokens or max_tokens == 200
