"""Crafted OnPair16 tables and strings that drive the encode kernel through
each of its tie rules.

A trained dictionary rarely reaches the corners of the parse: buckets of
more than 32 suffixes with the first fit at a lane boundary, probe chains
longer than a warp, a window with exactly 8 or 9 bytes left, bytes with no
single-byte entry. :func:`encode_case` builds tables (the fields of a
``PackedDictionary``, as numpy arrays) in which each of those happens at a
known place, and strings that hit them, each with the token its parse must
start with. The kernel, its plain version and the reference's kernel are
compared on them; the tables are consistent (every key a probe can match
maps to the token of those bytes), so a parse that ends without the
fallback also decodes back to its string.

Every table is 4,096 slots: the crafted probe chains sit in regions that no
other key's chain reaches, chosen by hashing candidate keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.packed import hash_key

SIZE = 4096
S_PROBE_MAX = 40
P_PROBE_MAX = 70
MAX_BUCKET = 128
#: bytes with no single-byte entry: the parse falls back to token 0, length 1
MISSING = (0xFE, 0xFF)
_M32 = 0xFFFFFFFF


def _key(b: bytes) -> tuple[int, int]:
    v = int.from_bytes(b[:8].ljust(8, b"\0"), "little")
    return v & _M32, v >> 32


class _Table:
    """An open-addressing table (the layout ``PackedDictionary`` builds) whose
    slots can also be set by hand."""

    def __init__(self, rng: np.random.Generator):
        self.lo = np.zeros(SIZE, dtype=np.uint32)
        self.hi = np.zeros(SIZE, dtype=np.uint32)
        self.len = np.zeros(SIZE, dtype=np.int32)
        self.pay = np.full(SIZE, -1, dtype=np.int32)
        self.kept_empty: set[int] = set()
        self.rng = rng

    def home(self, key: bytes) -> int:
        return hash_key(*_key(key), len(key)) & (SIZE - 1)

    def _put(self, slot: int, key: bytes, payload: int) -> None:
        self.lo[slot], self.hi[slot] = _key(key)
        self.len[slot] = len(key)
        self.pay[slot] = payload

    def insert(self, key: bytes, payload: int) -> None:
        """Linear-probe insertion, as the frozen tables are built."""
        slot = self.home(key)
        while self.len[slot]:
            slot = (slot + 1) & (SIZE - 1)
        self._put(slot, key, payload)

    def free(self, key: bytes, span: int) -> bool:
        h = self.home(key)
        return all(not self.len[(h + i) & (SIZE - 1)]
                   and (h + i) & (SIZE - 1) not in self.kept_empty
                   for i in range(span))

    def chain(self, key: bytes, payload: int, decoys: int, gap: bool = False) -> None:
        """``decoys`` occupied slots of the key's length holding other keys
        from its home slot on, then the key; with ``gap``, one empty slot
        before the key, so a probe stops there and never reaches it."""
        h = self.home(key)
        for i in range(decoys):
            fake = self.rng.integers(0, 256, len(key), dtype=np.uint8).tobytes()
            self._put((h + i) & (SIZE - 1), fake, 1)
        if gap:
            self.kept_empty.add((h + decoys) & (SIZE - 1))
        self._put((h + decoys + gap) & (SIZE - 1), key, payload)

    def pick(self, stem: bytes, length: int, span: int, near_end: bool = False) -> bytes:
        """The first key ``stem + counter`` of ``length`` bytes (the counter
        in printable characters) whose next ``span`` slots are free and kept
        free (and, with ``near_end``, whose home is in the table's last 6
        slots, so its chain wraps around). The stem is at least 2 bytes
        shorter than the key."""
        n = length - len(stem)
        for i in range(94 ** n):
            key = stem + bytes(33 + (i // 94 ** k) % 94 for k in range(n))
            if near_end and self.home(key) < SIZE - 6:
                continue
            if self.free(key, span):
                return key
        raise RuntimeError(f"no free region for {stem!r}")


@dataclass
class EncodeCase:
    """Crafted tables and the strings that exercise them."""

    arrays: dict[str, np.ndarray]
    s_probe_max: int
    p_probe_max: int
    max_bucket: int
    #: (what the string exercises, the string, the token its parse starts with)
    cases: list[tuple[str, bytes, int]] = field(default_factory=list)

    @property
    def strings(self) -> list[bytes]:
        return [s for _, s, _ in self.cases]


def encode_case(seed: int = 0, n_mixed: int = 2000) -> EncodeCase:
    """Build the crafted tables and strings; ``n_mixed`` more strings join
    random pieces of the crafted ones (seeded), so that the rules also meet
    mid-string and at every alignment."""
    rng = np.random.default_rng(seed)
    entries: list[bytes] = [bytes([b]) for b in range(256)]
    ids: dict[bytes, int] = {}

    def entry(b: bytes) -> int:
        if b not in ids:
            ids[b] = len(entries) if len(b) > 1 else b[0]
            if len(b) > 1:
                entries.append(b)
        return ids[b]

    s, p = _Table(rng), _Table(rng)
    for b in range(256):
        ids[bytes([b])] = b
        if b not in MISSING:
            s.insert(bytes([b]), b)
    for word in (b"ab", b"the ", b"and", b"Q005", b"of the", b"zz", b"abcdefgh"):
        s.insert(word, entry(word))

    # ---- long tier: buckets, each under one 8-byte prefix ----
    suffixes: list[tuple[bytes, int]] = []   # (suffix, token) in bucket order
    starts, sizes = [], []

    def bucket(prefix: bytes, sufs: list[bytes]) -> int:
        starts.append(len(suffixes))
        sizes.append(len(sufs))
        suffixes.extend((x, entry(prefix + x)) for x in sufs)
        return len(starts) - 1

    # bucket A: 100 suffixes of 8 bytes, then 4 each of 7 .. 1 bytes (128 in
    # all, descending length as the tables order them), and 2 more of 1 byte
    # past max_bucket that the parse must never reach
    eight = [b"Q%03dwxyz" % k for k in range(100)]
    short = {7: [b"Q005wxy", b"Aaaaaaa", b"Abbbbbb", b"Acccccc"],
             6: [b"Q005wx", b"Bbbbbb", b"Bcccccc"[:6], b"Bdddddd"[:6]],
             5: [b"Ccccc", b"Cdddd", b"Ceeee", b"Cffff"],
             4: [b"Q005", b"Dddd", b"Deee", b"Dfff"],
             3: [b"Eee", b"Eff", b"Egg", b"Ehh"],
             2: [b"Ff", b"Fg", b"Fh", b"Fi"],
             1: [b"G", b"H", b"I", b"z"]}
    a_sufs = eight + [x for n in range(7, 0, -1) for x in short[n]] + [b"!", b"#"]
    assert len(a_sufs) == MAX_BUCKET + 2 and a_sufs[127] == b"z"
    ka = p.pick(b"BIGBKT", 8, 1)
    s.insert(ka, entry(ka))                   # the prefix alone: 8 bytes left
    p.chain(ka, bucket(ka, a_sufs), 0)
    # bucket B (40 suffixes) at probe lane 31; C (64) at lane 40; D at the
    # last probe allowed (lane 69); E wraps around the table's end
    kb = p.pick(b"LANE31", 8, 32)
    p.chain(kb, bucket(kb, [b"R%03dwxyz" % k for k in range(40)]), 31)
    kc = p.pick(b"LANE40", 8, 41)
    p.chain(kc, bucket(kc, [b"S%03dwxyz" % k for k in range(64)]), 40)
    kd = p.pick(b"LANE69", 8, 70)
    p.chain(kd, bucket(kd, [b"T", b"U"]), P_PROBE_MAX - 1)
    ke = p.pick(b"WRAPAR", 8, 12, near_end=True)
    p.chain(ke, bucket(ke, [b"V"]), 9)
    # prefixes the probe must not find: behind an empty slot at lane 0 (the
    # key is in no slot), at lane 31, at lane 45, and past probe_max
    miss = {"empty at lane 0": p.pick(b"NOKEY0", 8, 1)}
    p.kept_empty.add(p.home(miss["empty at lane 0"]))
    for name, stem, decoys, gap in (("empty at lane 31", b"EMPT31", 31, True),
                                    ("empty at lane 45", b"EMPT45", 45, True),
                                    ("past probe_max", b"PASTPM", P_PROBE_MAX, False)):
        k = p.pick(stem, 8, decoys + 2)
        p.chain(k, bucket(k, [b"W"]), decoys, gap)
        miss[name] = k

    # ---- short tier: chains of one key length ----
    c6 = s.pick(b"ch", 6, 36)
    s.chain(c6, entry(c6), 35)                # found at lane 35
    c7 = s.pick(b"lg", 7, 31)
    s.chain(c7, entry(c7), 30)                # 7 bytes, found at lane 30 ...
    c7_6 = c7[:6]
    s.insert(c7_6, entry(c7_6))               # ... its 6-byte prefix sooner
    c5 = s.pick(b"ls", 5, 40)
    s.chain(c5, entry(c5), S_PROBE_MAX - 1)   # the last probe allowed
    c4 = s.pick(b"ps", 4, 41)
    s.chain(c4, entry(c4), S_PROBE_MAX)       # one past it: never found
    c3 = s.pick(b"g", 3, 8)
    s.chain(c3, entry(c3), 5, gap=True)       # behind an empty slot

    def tok(b: bytes) -> int:
        return ids[b]

    cases = [
        ("bucket A: first fit at 0 (rem 16)", ka + eight[0], tok(ka + eight[0])),
        ("bucket A: first fit at 31", ka + eight[31] + b"and", tok(ka + eight[31])),
        ("bucket A: first fit at 32 (rem 17)", ka + eight[32] + b"!", tok(ka + eight[32])),
        ("bucket A: first fit at 33", ka + eight[33] + b"the ", tok(ka + eight[33])),
        ("bucket A: first fit at 127 (rem 9)", ka + b"z", tok(ka + b"z")),
        ("bucket A: first fit at 99", ka + eight[99] + eight[99], tok(ka + eight[99])),
        ("bucket A: 7 bytes left after the prefix", ka + b"Q005wxy", tok(ka + b"Q005wxy")),
        ("bucket A: the longest suffix too long for rem", ka + b"Q005wx",
         tok(ka + b"Q005wx")),
        ("bucket A: rem 12, a 4-byte fit", ka + b"Q005", tok(ka + b"Q005")),
        ("bucket A: no fit at all", ka + b"~~~~~~~~", tok(ka)),
        ("bucket A: the only fit past max_bucket", ka + b"!!", tok(ka)),
        ("rem 8: the prefix alone goes to the short tier", ka, tok(ka)),
        ("rem 8 at the second token", b"ab" + ka, tok(b"ab")),
        ("rem 9 at the second token", b"zz" + ka + b"G", tok(b"zz")),
        ("bucket B at probe lane 31, first fit at 33", kb + b"R033wxyz",
         tok(kb + b"R033wxyz")),
        ("bucket B, last suffix (39)", kb + b"R039wxyz", tok(kb + b"R039wxyz")),
        ("bucket C at probe lane 40, first fit at 63", kc + b"S063wxyz",
         tok(kc + b"S063wxyz")),
        ("bucket D at the last probe allowed", kd + b"U", tok(kd + b"U")),
        ("bucket E across the table's end", ke + b"V", tok(ke + b"V")),
        ("short chain: found at lane 35", c6 + b"and", tok(c6)),
        ("short chain: 7 bytes at lane 30 beat its 6-byte prefix", c7 + b"x",
         tok(c7)),
        ("short chain: only the 6-byte prefix", c7_6 + b"\0", tok(c7_6)),
        ("short chain: found at the last probe allowed", c5, tok(c5)),
        ("short chain: one past probe_max", c4, tok(c4[:1])),
        ("short chain: behind an empty slot", c3, tok(c3[:1])),
        ("no single-byte entry: token 0, length 1", bytes(MISSING) + b"ab", 0),
        ("one byte", b"G", tok(b"G")),
        ("the 8-byte short entry", b"abcdefgh", tok(b"abcdefgh")),
        ("empty", b"", -1),
    ] + [(f"prefix {name}", k + b"W" + b"x" * 8, tok(k[:1]))
         for name, k in miss.items()]

    # strings joined from random pieces of the crafted ones: every rule
    # mid-string, at every alignment, with the missing bytes between
    pieces = [c for _, c, _ in cases if c] + [bytes(MISSING[:1]), b"x" * 9]
    for _ in range(n_mixed):
        k = int(rng.integers(1, 6))
        parts = [pieces[int(i)] for i in rng.integers(0, len(pieces), k)]
        cases.append(("mixed", b"".join(parts)[: int(rng.integers(1, 200))], -1))

    lens = np.array([len(e) for e in entries], dtype=np.int32)
    mat16 = np.zeros((len(entries), 16), dtype=np.uint8)
    for i, e in enumerate(entries):
        mat16[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    suf = [_key(x) for x, _ in suffixes]
    arrays = {
        "mat16": mat16, "lens": lens,
        "s_lo": s.lo, "s_hi": s.hi, "s_len": s.len, "s_tok": s.pay,
        "p_lo": p.lo, "p_hi": p.hi, "p_len": p.len, "p_bucket": p.pay,
        "bucket_start": np.array(starts, dtype=np.int32),
        "bucket_size": np.array(sizes, dtype=np.int32),
        "suf_lo": np.array([lo for lo, _ in suf], dtype=np.uint32),
        "suf_hi": np.array([hi for _, hi in suf], dtype=np.uint32),
        "suf_len": np.array([len(x) for x, _ in suffixes], dtype=np.int32),
        "suf_tok": np.array([t for _, t in suffixes], dtype=np.int32),
    }
    assert not p.len[p.home(miss["empty at lane 0"])]
    return EncodeCase(arrays=arrays, s_probe_max=S_PROBE_MAX,
                      p_probe_max=P_PROBE_MAX, max_bucket=MAX_BUCKET, cases=cases)
