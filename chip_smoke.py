"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with one
nvcc command, then drives the port's paths at a realistic size, 32 MiB of
synthetic book titles (seed 0), each with every kernel's launch count and
every plain version's call count set to 0 just before it and read just
after:

1. read path: an OnPair16 dictionary trained on an 8 MiB sample, the whole
   corpus encoded through ``Encoder`` (the encode kernel), and every string
   read back once through ``CompressedStringStore.multiget`` (the decode
   kernel, one launch per call over the store's device mirror of its
   segments) in shuffled 1024-id batches;
2. full decompression: ``Decoder.decode_all`` of the whole corpus (the
   stream kernel, one launch over the corpus's u16 tokens);
3. scan: ``CompressedStringStore.scan`` over every id, in segment-sized
   ranges and in one range (the stream kernel, one launch per range over
   the store's device mirror, no token upload);
4. writable store: a ``MutableStringStore`` over the first half, the second
   half appended by ``extend`` in 1024-string batches with seals running
   off-thread (the encode kernel), multigets and a scan across the
   sealed/tail boundary (the decode kernel once per call for sealed ids and
   once more when a call touches the tail, and the stream kernel once per
   scan for sealed strings and once more for the tail), and one
   ``compact()`` (all three).

Every string each path returns is checked against its source, each path's
encode launches are recomputed from the bucketed encode's chunking (per
length cap, chunks of up to ``encode_pad_batch`` strings and
``ops._ENCODE_CHUNK_BYTES`` padded bytes), its decode launches from its
multiget calls and its stream launches from its scan ranges. Afterwards it profiles a window of each path (device busy
share, and the host's own time under cProfile), holds each kernel against
its plain PyTorch version on the card, exactly, at the paths' shapes (for
the encode kernel: every launch of the whole-corpus encode, and the corpus
payload equals the plain version's tokens; for the decode kernel: a real
multiget's rows, every store bucket's strings from the device mirror, tail
rows and the padded contract; for the stream kernel: uint16 and int32 tokens
at tile edges, across more than a warp of look-back, on mirror ranges that
start at any token, and thousands of calls back to back), at edge cases and,
for the encode kernel, on the crafted tables of
``repro_torch.kernels.crafted`` (buckets of more than 32 suffixes, probe
chains past a warp, 8 or 9 bytes left, truncation, batches of 1, 13 and 0
strings), times both with CUDA events and torch.profiler, and prints the
numbers beside the card's name and power limit. Every failure
raises; the last line is the result the caller reads. Without a card it
exits non-zero and prints no result. Imports nothing of JAX and nothing of
``repro``.
"""

from __future__ import annotations

import cProfile
import hashlib
import json
import os
import pstats
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_BYTES = 32 << 20
SAMPLE_BYTES = 8 << 20
SEED = 0
MULTIGET_IDS = 1024
EXTEND_BATCH = 1024
STRINGS_PER_SEGMENT = 4096
PARITY_STRINGS = 4096
ENCODE_WINDOW = 1 << 16  # strings appended under the profiler
MULTIGET_WINDOW = 200  # 1024-id batches read under the profiler
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
EDGE = [b"", b"a", b"ab", b"abcdefgh", b"abcdefghi", b"x" * 100,
        bytes(range(256)), b"\x00" * 20, b"abracadabra abracadabra"]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: kernel symbols as the profiler names them
KERNEL_SYMBOLS = {"decode_compact": "decode_rows_kernel",
                  "encode_batch": "encode_batch_kernel",
                  "decode_tokens": "decode_stream_kernel"}


def device_ms(fn, symbol: str, reps: int) -> tuple[float | None, dict[str, int]]:
    """Mean device time per call of ``fn`` spent in the CUDA kernels whose
    names hold ``symbol``, from torch.profiler: the kernels alone, without
    the host's launch overhead (None when the profiler recorded no device
    time for them); and the count of each device activity over the ``reps``
    calls (kernels by name, copies and sets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "self_device_time_total", 0)
                   for ev in prof.key_averages() if symbol in ev.key and ev.count)
    seen: dict[str, int] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ("Memcpy" if "Memcpy" in ev.name else
                    "Memset" if "Memset" in ev.name else  # a kernel, without its arguments
                    re.sub(r"\(.*\)$", "", ev.name.replace("(anonymous namespace)::", "")))
            seen[name] = seen.get(name, 0) + 1
    return (total_us / reps / 1e3 if total_us > 0 else None), seen


def device_window(fn) -> tuple[float, dict[str, list]]:
    """Run ``fn`` once under torch.profiler. Returns the window's wall seconds
    and, per device activity (each kernel by name, copies, sets), its count
    and summed device seconds. Empty when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acts: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = next((n for n, sym in KERNEL_SYMBOLS.items() if sym in ev.name),
                   "copies" if "Memcpy" in ev.name else
                   "sets" if "Memset" in ev.name else "other kernels")
        entry = acts.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += ev.time_range.elapsed_us() / 1e6
    return wall, acts


def encode_launch_shapes(strings: list[bytes], caps0, pad_batch: int,
                         chunk_bytes: int) -> list:
    """The (strings, cap) of each launch the bucketed encode makes for
    ``strings``, in order: per length cap (caps0 grown by doubling to the
    longest string), chunks of ``pad_batch`` strings and at most
    ``chunk_bytes`` padded bytes, the last one smaller. Each entry is (cap,
    indices of the chunk's strings)."""
    lens = np.fromiter((max(len(s), 1) for s in strings), np.int64, len(strings))
    caps = list(caps0)
    while lens.size and caps[-1] < lens.max():
        caps.append(2 * caps[-1])
    cap_of = np.asarray(caps)[np.searchsorted(caps, lens, side="left")]
    return [(int(cap), members[c0 : c0 + chunk])
            for cap in np.unique(cap_of)
            for members in (np.flatnonzero(cap_of == cap),)
            for chunk in (max(1, min(pad_batch, chunk_bytes // (int(cap) + 16))),)
            for c0 in range(0, members.size, chunk)]


def shape_counts(launches: list) -> dict[tuple[int, int], int]:
    """Launches per (B, cap) shape."""
    out: dict[tuple[int, int], int] = {}
    for cap, sel in launches:
        out[(sel.size, cap)] = out.get((sel.size, cap), 0) + 1
    return out


def check_equal(name: str, case: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Raise unless a kernel's output equals its plain version's exactly."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max() \
            if got.shape == want.shape else "shape"
        raise AssertionError(f"{name} {case}: kernel differs from the plain "
                             f"version ({tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max abs err {diff})")


def check_strings(path: str, got: list[bytes], want: list[bytes]) -> None:
    """Raise unless a path returned exactly its source strings."""
    if len(got) != len(want):
        raise AssertionError(f"{path}: {len(got)} strings, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"{path}: string {i} differs from its source")


class PathCounts:
    """Launch counts of the kernels and call counts of their plain versions
    over one driven path: zeroed by ``start``, read and checked by ``end``."""

    def __init__(self, kernels: dict, plain: list):
        self.kernels, self.plain = kernels, plain
        self.total = dict.fromkeys(kernels, 0)

    def start(self) -> None:
        for fn in self.kernels.values():
            fn.launches = 0
        for fn in self.plain:
            fn.calls = 0

    def end(self, path: str, expect: list[str]) -> dict[str, int]:
        launches = {name: fn.launches for name, fn in self.kernels.items()}
        calls = sum(fn.calls for fn in self.plain)
        log(path, f"launches {launches}; plain versions called {calls} times")
        missing = [name for name in expect if launches[name] < 1]
        if missing:
            raise AssertionError(f"{path}: kernels of the path never launched: {missing}")
        if calls:
            raise AssertionError(f"{path}: the path called a plain version on the card")
        for name, n in launches.items():
            self.total[name] += n
        return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.api import CompressedCorpus
    from repro_torch.core.codec import Decoder, Encoder
    from repro_torch.core.lpm import lpm_from_entries
    from repro_torch.core.metrics import throughput_mib_s
    from repro_torch.core.onpair import OnPairConfig, train_dictionary
    from repro_torch.core.packed import PackedDictionary
    from repro_torch.data.synth import load_dataset
    from repro_torch.kernels import (_build, crafted, onpair_decode, onpair_encode,
                                     ops, ref)
    from repro_torch.store import CompressedStringStore, MutableStringStore

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    # ---------------------------------------------------------------- 1. env
    log("env", f"python {sys.version.split()[0]}; torch {torch.__version__}; "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(card, flush=True)

    # -------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load()
    log("build", f"{_build.build_info['path']} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("build", line.strip())

    # ------------------------------------------------------- 3. data (set-up)
    t0 = time.perf_counter()
    strings = load_dataset("book_titles", DATA_BYTES, seed=SEED)
    raw_bytes = sum(map(len, strings))
    n_all = len(strings)
    log("data", f"book_titles: {n_all} strings, {raw_bytes} B, mean "
        f"{raw_bytes / n_all:.1f} B, made in {time.perf_counter() - t0:.1f} s")

    counts = PathCounts({"decode_compact": onpair_decode.decode_compact,
                         "encode_batch": onpair_encode.encode_batch,
                         "decode_tokens": onpair_decode.decode_tokens},
                        [ref.decode_batch_ref, ref.decode_rows_ref,
                         ref.encode_batch_ref, ref.decode_tokens_ref])

    # --------------------------------------- 4.1 read path: encode + multiget
    counts.start()
    ref_batches_before = ops._DECODE_BATCHES["ref"].value
    cuda_batches_before = ops._DECODE_BATCHES["cuda"].value
    config = OnPairConfig.onpair16(sample_bytes=SAMPLE_BYTES, seed=SEED)
    t0 = time.perf_counter()
    trained = train_dictionary(strings, config)
    dictionary = PackedDictionary.build(trained.entries)
    train_s = time.perf_counter() - t0
    log("read", f"trained {dictionary.num_entries} entries from "
        f"{trained.scanned_bytes} sample bytes in {train_s:.1f} s; tables "
        f"{dictionary.resident_bytes} B")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = Encoder(dictionary, device=dev).encode(strings)
    encode_s = time.perf_counter() - t0
    store = CompressedStringStore(dictionary, corpus, device=dev, cache_bytes=0,
                                  strings_per_segment=STRINGS_PER_SEGMENT)

    order = np.random.default_rng(SEED).permutation(n_all)
    batches = [order[i : i + MULTIGET_IDS].tolist()
               for i in range(0, n_all, MULTIGET_IDS)]
    lat, answers = [], []
    t0 = time.perf_counter()
    for ids in batches:
        t1 = time.perf_counter()
        answers.append(store.multiget(ids))
        lat.append(time.perf_counter() - t1)
    multiget_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for ids, got in zip(batches, answers):  # checked outside the timed loop
        check_strings("multiget", got, [strings[i] for i in ids])
    del answers

    launches = counts.end("read", ["decode_compact", "encode_batch"])
    log("read", "repro_kernel_decode_batches_total{path=cuda} +"
        f"{ops._DECODE_BATCHES['cuda'].value - cuda_batches_before}, "
        f"{{path=ref}} +{ops._DECODE_BATCHES['ref'].value - ref_batches_before}")
    if ops._DECODE_BATCHES["ref"].value != ref_batches_before:
        raise AssertionError("repro_kernel_decode_batches_total{path=ref} moved")
    if store.stats.decoded_strings != n_all:
        raise AssertionError("not every string was decoded exactly once")
    decoded_bytes = store.stats.decoded_bytes
    log("read", f"device mirror of the sealed segments: {store.resident_device_bytes} "
        f"B on the card ({store.resident.n_bytes} B of payload, "
        f"{8 * (store.resident.n_strings + 1)} B of token starts, spare room)")

    # launches per shape, recomputed from the inputs, must add up to the counts
    pad_batch = store._device.encode_pad_batch
    chunk_bytes = ops._ENCODE_CHUNK_BYTES
    read_launches = encode_launch_shapes(strings, ops._ENCODE_LEN_BUCKETS, pad_batch,
                                         chunk_bytes)
    enc_shapes = shape_counts(read_launches)
    caps_enc = sorted(set(ops._ENCODE_LEN_BUCKETS) | {cap for cap, _ in read_launches})
    log("read", f"encode launches per (B, cap): {enc_shapes} (chunks of up to "
        f"{pad_batch} strings)")
    tok_counts = corpus.token_counts()
    caps_dec = [int(c) for c in store.bucket_caps]
    if len(read_launches) != launches["encode_batch"]:
        raise AssertionError(f"encode launches per shape {enc_shapes} do not add "
                             f"up to {launches['encode_batch']}")
    # one decode launch per multiget call: every id of a call misses (no
    # cache), and 1,024 ids stay under a launch's row cap
    if launches["decode_compact"] != len(batches):
        raise AssertionError(f"read: {launches['decode_compact']} decode launches "
                             f"for {len(batches)} multiget calls")

    # ---------------------------------------- 4.2 full decompression
    counts.start()
    decoder = Decoder(dictionary, device=dev)
    joined = b"".join(strings)
    decode_all_s = []
    for _ in range(4):  # the first call is the path's; three more for spread
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = decoder.decode_all(corpus)
        decode_all_s.append(time.perf_counter() - t0)
        if whole != joined:
            raise AssertionError("decode_all != the concatenated source strings")
    del whole
    stream_full_launches = counts.end("decode_all", ["decode_tokens"])["decode_tokens"]

    # the same calls in a process that has run nothing else: decode_all's
    # host steps depend on what the process allocated before them
    probe_file = os.path.join(ROOT, "build", "decode_all_probe.npz")
    os.makedirs(os.path.dirname(probe_file), exist_ok=True)
    np.savez(probe_file, entries=np.frombuffer(b"".join(dictionary.entries), np.uint8),
             entry_lens=dictionary.lens, payload=corpus.payload,
             offsets=corpus.offsets, raw_bytes=raw_bytes)
    try:
        probe = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--decode-all-probe", probe_file],
                               capture_output=True, text=True, timeout=600)
    finally:
        os.remove(probe_file)
    if probe.returncode != 0:
        raise RuntimeError(f"decode_all in a fresh process failed:\n{probe.stderr[-4000:]}")
    fresh = json.loads(probe.stdout.strip().splitlines()[-1])
    if fresh["sha256"] != hashlib.sha256(joined).hexdigest():
        raise AssertionError("decode_all in a fresh process != the source strings")

    # -------------------------------------------------------------- 4.3 scan
    tok_off = corpus.offsets // 2  # token start of each string

    def stream_calls(lo: int, hi: int, sealed: int) -> int:
        """Stream launches of scan(lo, hi): one for its sealed strings and
        one for its tail strings, each when it holds tokens."""
        return sum(a < b and tok_off[b] > tok_off[a]
                   for a, b in ((lo, min(hi, sealed)), (max(lo, sealed), hi)))

    counts.start()
    n_seg = store.segments.n_segments
    t0 = time.perf_counter()
    scanned = []
    for lo in range(0, n_all, STRINGS_PER_SEGMENT):
        scanned.extend(store.scan(lo, min(lo + STRINGS_PER_SEGMENT, n_all)))
    scan_seg_s = time.perf_counter() - t0
    check_strings("scan, segment-sized ranges", scanned, strings)
    t0 = time.perf_counter()
    scanned = store.scan(0, n_all)
    scan_all_s = time.perf_counter() - t0
    check_strings("scan(0, n)", scanned, strings)
    del scanned
    scan_launches = counts.end("scan", ["decode_tokens"])["decode_tokens"]
    expect_scan = stream_calls(0, n_all, n_all) + sum(
        stream_calls(lo, min(lo + STRINGS_PER_SEGMENT, n_all), n_all)
        for lo in range(0, n_all, STRINGS_PER_SEGMENT))
    if scan_launches != expect_scan:
        raise AssertionError(f"scan: {scan_launches} stream launches, expected "
                             f"{expect_scan} (one per range of {n_seg} "
                             "segment-sized ranges and scan(0, n))")

    # ---------------------------------------------------- 4.4 writable store
    counts.start()
    half = n_all // 2
    cut = int(corpus.offsets[half])
    first = CompressedCorpus(payload=corpus.payload[:cut],
                             offsets=corpus.offsets[: half + 1].copy(),
                             raw_bytes=sum(map(len, strings[:half])),
                             meta=dict(corpus.meta))
    wstore = MutableStringStore(dictionary, first, device=dev, config=config,
                                strings_per_segment=STRINGS_PER_SEGMENT,
                                cache_bytes=0)
    extend_launches = [encode_launch_shapes(strings[lo : lo + EXTEND_BATCH],
                                            ops._ENCODE_LEN_BUCKETS, pad_batch,
                                            chunk_bytes)
                       for lo in range(half, n_all, EXTEND_BATCH)]
    t0 = time.perf_counter()
    for lo in range(half, n_all, EXTEND_BATCH):
        ids = wstore.extend(strings[lo : lo + EXTEND_BATCH])
        if ids[0] != lo or len(ids) != min(EXTEND_BATCH, n_all - lo):
            raise AssertionError(f"extend at {lo} returned ids from {ids[0]}")
    extend_s = time.perf_counter() - t0
    extend_raw = raw_bytes - first.raw_bytes
    wstore.seal_barrier()
    snap = wstore.snapshot_corpus()
    if not (np.array_equal(snap.payload, corpus.payload)
            and np.array_equal(snap.offsets, corpus.offsets)):
        raise AssertionError("writable store: snapshot_corpus() != the one-shot encode")
    sealed, tail = wstore.n_sealed, wstore.n_strings - wstore.n_sealed
    log("write", f"after extend + seal_barrier: {sealed} sealed strings in "
        f"{wstore.segments.n_segments} segments, {tail} in the tail; snapshot "
        "payload and offsets == the one-shot encode")
    if not (0 < tail < STRINGS_PER_SEGMENT):
        raise AssertionError("the writable store has no sealed/tail boundary")
    rng = np.random.default_rng(SEED + 1)
    around = [i for i in range(sealed - 5, sealed + 5) if 0 <= i < n_all]
    tail_ids = rng.integers(sealed, n_all, 512).tolist()
    # the calls' decode launches: one for sealed ids, one for tail ids
    write_multigets = [around, rng.integers(0, n_all, 4096).tolist() + around, tail_ids]
    expect_decode = sum(any(i < sealed for i in ids) + any(i >= sealed for i in ids)
                        for ids in write_multigets)
    tail_launches = sum(any(i >= sealed for i in ids) for ids in write_multigets)
    for ids in write_multigets:
        check_strings("writable multiget", wstore.multiget(ids),
                      [strings[i] for i in ids])
    write_scans = ((sealed - 3000, n_all), (sealed - 1, sealed + 1),
                   (sealed, n_all), (half - 10, half + 10))
    for lo, hi in write_scans:
        check_strings(f"writable scan({lo}, {hi})", wstore.scan(lo, hi),
                      strings[lo:hi])
    # compact() reads the store in segment-sized chunks, then the strings
    # appended meanwhile (none here); the scan after it is sealed throughout
    expect_stream = sum(stream_calls(lo, hi, sealed) for lo, hi in write_scans) + sum(
        stream_calls(lo, min(lo + STRINGS_PER_SEGMENT, n_all), sealed)
        for lo in range(0, n_all, STRINGS_PER_SEGMENT)) + 1
    report = wstore.compact()
    log("write", f"compact: {report}")
    check_strings("scan after compact", wstore.scan(0, n_all), strings)
    ids = rng.integers(0, n_all, 4096).tolist()
    check_strings("multiget after compact", wstore.multiget(ids),
                  [strings[i] for i in ids])
    expect_decode += 1  # compact sealed every string
    log("write", f"device mirror after compact: {wstore.resident_device_bytes} B on "
        f"the card for {wstore.resident.n_strings} sealed strings")
    snap = wstore.snapshot_corpus()
    same_payload = (np.array_equal(snap.payload, corpus.payload)
                    and np.array_equal(snap.offsets, corpus.offsets))
    log("write", "after compact (the same strings and training config as "
        f"the first dictionary): payload == the one-shot encode: {same_payload}")
    write = counts.end("write", ["encode_batch", "decode_compact", "decode_tokens"])
    n_extend = sum(map(len, extend_launches))
    # extend: one launch per length cap present in a batch; compact re-encodes
    # every string as the read path's encode did
    if write["encode_batch"] != n_extend + len(read_launches):
        raise AssertionError(f"write: {write['encode_batch']} encode launches, "
                             f"expected {n_extend} (extend) + {len(read_launches)} (compact)")
    if write["decode_compact"] != expect_decode:
        raise AssertionError(f"write: {write['decode_compact']} decode launches for "
                             f"{len(write_multigets) + 1} multiget calls, expected "
                             f"{expect_decode} ({tail_launches} of them for the tail)")
    if write["decode_tokens"] != expect_stream:
        raise AssertionError(f"write: {write['decode_tokens']} stream launches, "
                             f"expected {expect_stream}")
    del snap

    # ------------------------------------------- 5. device share of each path
    # a window of each path, driven as above but under torch.profiler (after
    # the counts were read): kernel device time over the window's wall
    encoder = Encoder(dictionary, device=dev)
    wwin = MutableStringStore(dictionary, corpus, device=dev, config=config,
                              strings_per_segment=STRINGS_PER_SEGMENT,
                              cache_bytes=0)

    def extend_window():
        for lo in range(0, ENCODE_WINDOW, EXTEND_BATCH):
            wwin.extend(strings[lo : lo + EXTEND_BATCH])
        wwin.seal_barrier()

    windows = {
        "encode": device_window(lambda: encoder.encode(strings)),
        "multiget": device_window(
            lambda: [store.multiget(ids) for ids in batches[:MULTIGET_WINDOW]]),
        "decode_all": device_window(lambda: decoder.decode_all(corpus)),
        "scan": device_window(lambda: store.scan(0, n_all)),
        "extend": device_window(extend_window),
        "compact": device_window(wwin.compact),
    }
    path_ms: dict[str, dict[str, float]] = {}
    for path, (wall, acts) in windows.items():
        if not acts:
            log("device", f"[{card}] {path}: torch.profiler recorded no device "
                "time; busy share not measured")
            continue
        busy = sum(sec for _, sec in acts.values())
        kernels_s = sum(acts.get(k, (0, 0.0))[1] for k in KERNEL_SYMBOLS)
        log("device", f"[{card}] {path} window (torch.profiler, {wall:.3f} s wall): "
            + "; ".join(f"{k} {n} x, {sec:.4f} s" for k, (n, sec) in sorted(acts.items()))
            + f"; device busy {busy / wall:.2%}, kernels of the path "
            f"{kernels_s / wall:.2%}")
        for name in KERNEL_SYMBOLS:
            if name in acts:  # mean device ms per wrapper call in the window
                path_ms.setdefault(name, {})[path] = acts[name][1] / acts[name][0] * 1e3
    log("device", f"mean device ms per wrapper call over each window: {path_ms}")

    def host_profile(fn, top: int = 8) -> str:
        """Wall of ``fn`` under cProfile and the functions with the most
        time of their own (the main thread's host work; a wait for the card
        shows in the call that synchronises)."""
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        fn()
        torch.cuda.synchronize()
        prof.disable()
        wall = time.perf_counter() - t0
        rows = sorted(((tt, f"{os.path.basename(f)}:{line}({name})")
                       for (f, line, name), (_, _, tt, _, _) in
                       pstats.Stats(prof).stats.items()), reverse=True)[:top]
        return f"{wall:.3f} s wall; " + "; ".join(f"{n} {tt:.3f} s" for tt, n in rows)

    log("host", f"[{card}] encode of the whole corpus under cProfile: "
        f"{host_profile(lambda: encoder.encode(strings))}")
    log("host", f"[{card}] 64 extend batches of 1,024 under cProfile: "
        f"{host_profile(extend_window)}")
    log("host", f"[{card}] decode_all under cProfile: "
        f"{host_profile(lambda: decoder.decode_all(corpus))}")
    log("host", f"[{card}] {MULTIGET_WINDOW} multiget calls of {MULTIGET_IDS} ids "
        "under cProfile: " + host_profile(
            lambda: [store.multiget(ids) for ids in batches[:MULTIGET_WINDOW]], top=12))
    log("host", f"[{card}] scan(0, n) under cProfile: "
        f"{host_profile(lambda: store.scan(0, n_all))}")
    del wwin

    # ---------------------------------------------------- 6. kernel parity
    dd = store._device.dd
    lpm = lpm_from_entries(dictionary.entries)

    long_tok = torch.from_numpy(dictionary.lens > 8).to(dev)

    def encode_bytes(D, L, toks, n) -> int:
        """Bytes an encode launch must move: inputs read once, outputs written
        once, and one table record per distinct token emitted (a 16-byte
        short-table slot, or a prefix slot + bucket bounds + a suffix record,
        40 B, for a token longer than 8 B)."""
        valid = torch.arange(toks.shape[1], device=dev) < n[:, None]
        used = torch.unique(toks[valid].to(torch.int64))
        n_long = int(long_tok[used].sum())
        return (D.numel() + L.numel() * 4 + toks.numel() * 4 + n.numel() * 4
                + 16 * (used.numel() - n_long) + 40 * n_long)

    def encode_pair(batch, cap, max_tokens, case, tables=dd, host=True):
        """Kernel == plain version (whole outputs), one launch (none for an
        empty batch), and == the host LPM parse of the trained dictionary
        when ``host``."""
        data, lens = ops.pack_strings(batch, pad_len=cap)
        D, L = torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)
        before = onpair_encode.encode_batch.launches
        got = onpair_encode.encode_batch(D, L, tables, max_tokens)
        if onpair_encode.encode_batch.launches - before != (1 if batch else 0):
            raise AssertionError(f"encode_batch {case}: wrong number of launches")
        want = ref.encode_batch_ref(D, L, tables, max_tokens)
        if host:
            toks, n = got[0].cpu().numpy(), got[1].cpu().numpy()
            ptoks, pn = want[0].cpu().numpy(), want[1].cpu().numpy()
            for i, s in enumerate(batch):
                parsed = lpm.parse(s)[:max_tokens]
                if toks[i, : n[i]].tolist() != parsed or ptoks[i, : pn[i]].tolist() != parsed:
                    raise AssertionError(
                        f"encode_batch {case}, row {i} {s!r}: host parse {parsed}, "
                        f"kernel {toks[i, : n[i]].tolist()}, plain "
                        f"{ptoks[i, : pn[i]].tolist()}")
        check_equal("encode_batch", f"{case} tokens", got[0], want[0])
        check_equal("encode_batch", f"{case} n_tokens", got[1], want[1])
        return D, L, got

    def long_strings(n, lo, hi):
        joined_ = (b" / ".join(strings[i : i + 8]) for i in range(0, 80 * n, 8))
        return [s[:hi] for s in joined_ if len(s) > lo][:n]

    encode_pair(EDGE, 512, 512, "edge strings")
    encode_pair(EDGE[:6] + strings[:64], 128, 5, "max_tokens=5 truncation")
    encode_pair([], 32, 32, "B=0")
    lo = 0
    for cap in caps_enc:
        batch = [s for s in strings if lo < max(len(s), 1) <= cap][:PARITY_STRINGS]
        if len(batch) < 64:  # too few such titles: join some up to this cap
            batch = long_strings(PARITY_STRINGS, lo, cap)
        if len(batch) < 64:
            raise AssertionError(f"no parity strings for encode cap {cap}")
        encode_pair(batch, cap, cap, f"{len(batch)} corpus strings, cap {cap}")
        lo = cap
    # every launch of the read path's whole-corpus encode, again: kernel ==
    # plain, and the corpus holds exactly the plain version's tokens
    pay_tokens = corpus.payload.view("<u2")
    enc_inputs: dict[str, tuple] = {}   # shape label -> (D, L, launches)
    corpus_bound_bytes = 0
    for cap, sel in read_launches:
        D, L, (toks, n) = encode_pair([strings[i] for i in sel], cap, cap,
                                      f"read-path launch ({sel.size}, {cap}+16)",
                                      host=False)
        corpus_bound_bytes += encode_bytes(D, L, toks, n)
        n_ = n.cpu().numpy().astype(np.int64)
        flat = toks[torch.arange(cap, device=dev) < n[:, None]].cpu().numpy()
        idx = np.arange(flat.size) + np.repeat(tok_off[sel] - (np.cumsum(n_) - n_), n_)
        if not (np.array_equal(n_, np.diff(tok_off)[sel])
                and np.array_equal(pay_tokens[idx], flat.astype(np.uint16))):
            raise AssertionError(f"encode: the corpus payload of launch ({sel.size}, "
                                 f"{cap}) differs from the plain version's tokens")
        # the read path's shapes recur in compact's re-encode of every string
        enc_inputs.setdefault(f"({sel.size}, {cap}+16)",
                              (D, L, 2 * enc_shapes[(sel.size, cap)]))
    ext = strings[half : half + EXTEND_BATCH]
    for cap, sel in encode_launch_shapes(ext, ops._ENCODE_LEN_BUCKETS, pad_batch,
                                         chunk_bytes):
        D, L, _ = encode_pair([ext[i] for i in sel], cap, cap,
                              f"extend launch ({sel.size}, {cap}+16)", host=False)
        n_launch = sum(c == cap for batch in extend_launches for c, _ in batch)
        enc_inputs[f"extend batches at cap {cap}, first ({sel.size}, {cap}+16)"] = (
            D, L, n_launch)
    log("parity", f"encode_batch == plain == host LPM parse, exact: edge strings, max_tokens "
        f"truncation, B=0 (no launch), up to {PARITY_STRINGS} corpus strings in each cap "
        f"{caps_enc}; == plain on all {len(read_launches)} launches of the whole-corpus "
        f"encode (the payload, sha256 {hashlib.sha256(corpus.payload).hexdigest()[:16]}, "
        "is the plain version's tokens) and on the first extend batch's launches")

    case = crafted.encode_case(seed=SEED)
    cdd = ref.DeviceDict.from_arrays(case.arrays, s_probe_max=case.s_probe_max,
                                     p_probe_max=case.p_probe_max,
                                     max_bucket=case.max_bucket, device=dev)
    named = [c for c in case.cases if c[0] != "mixed"]
    _, _, (toks, n) = encode_pair([s for _, s, _ in named], 64, 64,
                                  "crafted named cases", cdd, host=False)
    for i, (name, _, first) in enumerate(named):
        if (int(toks[i, 0]) if int(n[i]) else -1) != first:
            raise AssertionError(f"encode_batch crafted case '{name}': first token "
                                 f"{int(toks[i, 0])}, built for {first}")
    for pad, mt in ((200, 200), (201, 200), (203, 7), (256, 1)):
        encode_pair(case.strings, pad, mt, f"crafted ({len(case.strings)}, "
                    f"{pad}+16), max_tokens={mt}", cdd, host=False)
    for B in (1, 13, 0):
        encode_pair(case.strings[:B], 200, 200, f"crafted B={B}", cdd, host=False)
    log("parity", f"encode_batch == plain, exact, on crafted tables: {len(named)} "
        "named cases (buckets of 40-130 suffixes with the first fit at 0, 31, 32, "
        "33, 39, 63, 99, 127, none, and only past max_bucket; prefix probes hit at "
        "lanes 0, 31, 40, 69 and across the table's end, and stop on an empty slot "
        "at lanes 0, 31, 45 and at probe_max; short chains hit at lanes 35 and 39, "
        "the longer of two lengths winning, miss past probe_max and behind an "
        "empty slot; 8, 9, 12, 16 and 17 bytes left; bytes with no entry), each "
        f"starting with the token it was built for, and {len(case.strings)} "
        "strings at row widths 216, 217, 219 and 272 (aligned and not), "
        "max_tokens 200, 7 and 1, and B = 1, 13 and 0 (no launch)")

    def decode_pair(tokens, n, case):
        T, N = torch.from_numpy(tokens).to(dev), torch.from_numpy(n).to(dev)
        out, olen = onpair_decode.decode_compact(T, N, dd.mat16, dd.lens)
        rout, rlen = ref.decode_batch_ref(T, N, dd.mat16, dd.lens)
        check_equal("decode_compact", f"{case} out_len", olen, rlen)
        width = 16 * tokens.shape[1] + 16
        cols = torch.arange(width, device=dev)
        valid = cols < olen[:, None].to(torch.int64)
        check_equal("decode_compact", f"{case} bytes", out[valid], rout[valid])
        return T, N

    sixteen = np.flatnonzero(dictionary.lens == 16).astype(np.int32)
    ones = np.flatnonzero(dictionary.lens == 1).astype(np.int32)
    decode_pair(np.zeros((0, 4), np.int32), np.zeros(0, np.int32), "B=0")
    decode_pair(np.zeros((1, 4), np.int32), np.zeros(1, np.int32), "n_tokens=0")
    decode_pair(np.array([[65], [66]], np.int32), np.array([1, 0], np.int32), "T=1")
    decode_pair(np.tile(sixteen[:8], (4, 1)), np.array([8, 7, 1, 0], np.int32),
                "16-byte rows")
    dec_inputs = {}
    bucket_of = np.searchsorted(store.bucket_caps, tok_counts, side="left")
    for j, cap in enumerate(caps_dec):
        members = np.flatnonzero(bucket_of == j)[:PARITY_STRINGS]
        for c0 in range(0, len(members), store.batch_size):
            lists = [np.asarray(corpus.string_tokens(int(i)), np.int32)
                     for i in members[c0 : c0 + store.batch_size]]
            pair = decode_pair(*ops.pack_token_matrix(
                lists, pad_tokens=cap, pad_batch=store.batch_size), f"(256, {cap})")
            dec_inputs.setdefault(cap, pair)
    log("parity", "decode_compact (padded contract) == plain, exact: B=0, "
        f"n_tokens=0, T=1, 16-byte rows, up to {PARITY_STRINGS} corpus strings per "
        f"store bucket at (256, cap) for caps {caps_dec}")

    host_lens = dictionary.lens.astype(np.int64)
    res = store.resident
    res_tokens, res_starts = res.on_device()

    def row_tokens(ids) -> np.ndarray:
        """The corpus tokens of strings ``ids``, back to back (int64)."""
        return np.concatenate([pay_tokens[tok_off[i] : tok_off[i + 1]] for i in ids]
                              + [np.zeros(0, np.uint16)]).astype(np.int64)

    def rows_bytes(toks: np.ndarray, M: int, by_id: bool, out_bytes: int) -> int:
        """Bytes a rows launch must move: the output offsets; by id, the ids
        and each row's two starts, else the rows' M + 1 starts; the tokens
        (uint16 by id, int32 from the host); each distinct dictionary row
        (16 B) and length (4 B) once; the decoded bytes and out_len."""
        starts = 8 * M + 16 * M if by_id else 8 * (M + 1)
        return (8 * (M + 1) + starts + (2 if by_id else 4) * toks.size
                + 20 * np.unique(toks).size + out_bytes + 4 * M)

    def rows_pair(tokens, starts, ids, off, case, lens_t=None, size=None):
        """decode_rows == plain on the card: out_len, and each row's bytes up
        to the smaller of its range and its out_len (all of them unless the
        length table lies or the output is cut short at ``size``); one
        launch, none for no rows."""
        lens_t = dd.lens if lens_t is None else lens_t
        off_t = torch.from_numpy(np.asarray(off, np.int64)).to(dev)
        ids_t = None if ids is None else torch.from_numpy(
            np.asarray(ids, np.int64)).to(dev)
        size = int(off[-1]) if size is None else size
        before = onpair_decode.decode_compact.launches
        out, olen = onpair_decode.decode_rows(tokens, starts, off_t, size, dd.mat16,
                                              lens_t, ids=ids_t)
        launched = onpair_decode.decode_compact.launches - before
        rout, rlen = ref.decode_rows_ref(tokens, starts, off_t, size, dd.mat16, lens_t,
                                         ids=ids_t)
        check_equal("decode_compact", f"rows {case} out_len", olen, rlen)
        span = off_t[1:] - off_t[:-1]
        keep = torch.minimum(span, olen.to(torch.int64))
        row = torch.repeat_interleave(torch.arange(span.numel(), device=dev),
                                      span)[:size]
        valid = torch.arange(size, device=dev) - off_t[:-1][row] < keep[row]
        check_equal("decode_compact", f"rows {case} bytes", out[valid], rout[valid])
        if launched != (1 if len(off) > 1 else 0):
            raise AssertionError(f"decode_rows {case}: {launched} launches")
        return tokens, starts, ids_t, off_t, size

    def host_rows(lists, dtype=np.int32):
        """Rows from host token lists (as the tail and Decoder.multiget
        send them): (tokens, starts, output offsets by the true lengths)."""
        toks = np.concatenate([np.asarray(t, np.int64) for t in lists]
                              + [np.zeros(0, np.int64)])
        counts = np.fromiter(map(len, lists), np.int64, len(lists))
        starts = np.concatenate(([0], np.cumsum(counts)))
        cum = np.concatenate(([0], np.cumsum(host_lens[toks])))
        return (torch.from_numpy(toks.astype(dtype)).to(dev),
                torch.from_numpy(starts).to(dev), np.concatenate(([0], np.cumsum(
                    np.diff(cum[starts])))))

    def mirror_off(ids) -> np.ndarray:
        return np.concatenate(([0], np.cumsum(res.raw_lens[np.asarray(ids)])))

    longest = int(np.argmax(tok_counts))
    edge_lists = [[], sixteen[:1], sixteen[:8], sixteen[:9], sixteen[:17],
                  np.resize(sixteen, 100), [], ones[:33], row_tokens([longest]), []]
    for dtype in (np.int32, np.uint16):
        tk, st, off = host_rows(edge_lists, dtype)
        rows_pair(tk, st, None, off, f"edge rows ({np.dtype(dtype).name}: 0 tokens, "
                  "16-byte entries, 1-100 tokens, the corpus's longest string)")
        rows_pair(tk, st, [], [0], f"M=0 ({np.dtype(dtype).name})")
        rows_pair(tk, st, None, off, f"an output 20 bytes short of the last row's "
                  f"range ({np.dtype(dtype).name})", size=int(off[-1]) - 20)
    lie = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        1, 17, dictionary.num_entries).astype(np.int32)).to(dev)
    ids = order[:2000]
    rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
              "2,000 mirror rows under a lying length table", lens_t=lie)
    ids = np.asarray([order[0], -1, res.n_strings, order[1], res.n_strings + 7,
                      -(1 << 40)], np.int64)
    has = (ids >= 0) & (ids < res.n_strings)
    room = np.where(has, res.raw_lens[np.where(has, ids, 0)], 16)
    rows_pair(res_tokens, res_starts, ids, np.concatenate(([0], np.cumsum(room))),
              "ids without a string (-1, n, n + 7, -2**40) among mirror rows")
    for j, cap in enumerate(caps_dec):
        ids = np.flatnonzero(bucket_of == j)[:PARITY_STRINGS]
        rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
                  f"{ids.size} mirror rows of bucket cap {cap}")
    rows_inputs = {}
    ids = np.asarray(batches[0])
    rows_inputs[f"a {ids.size}-id multiget from the mirror (uint16)"] = (
        rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
                  "a real 1,024-id multiget"),
        rows_bytes(row_tokens(ids), ids.size, True, int(mirror_off(ids)[-1])),
        counts.total["decode_compact"] - tail_launches)
    ids = order[: ops._DECODE_MAX_ROWS]
    rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
              f"a full launch of {ids.size} mirror rows")
    tail_u = list(dict.fromkeys(tail_ids))
    tk, st, off = host_rows([row_tokens([i]) for i in tail_u])
    rows_inputs[f"{len(tail_u)} tail rows from the host (int32)"] = (
        rows_pair(tk, st, None, off, "the writable phase's tail rows"),
        rows_bytes(row_tokens(tail_u), len(tail_u), False, int(off[-1])), tail_launches)
    log("parity", "decode_compact (rows) == plain, exact: int32 and uint16 edge rows "
        "(0 tokens, 16-byte entries, 1 to 100 tokens and the corpus's longest "
        f"string of {tok_counts[longest]}), M=0 (no launch), an output cut short "
        "(no write past it), a lying length table "
        "(no row past its range, out_len the lying total), ids without a string "
        f"(nothing written, out_len 0), up to {PARITY_STRINGS} "
        f"mirror rows of each bucket cap {caps_dec}, a real 1,024-id multiget, a "
        f"full launch of {ops._DECODE_MAX_ROWS} rows, the tail rows of the writable "
        "phase")

    def stream_pair(tokens, n, max_out, case):
        """The stream kernel == its plain version: every output byte (zeros
        past out_len included) and out_len; one launch (none without
        tokens). ``tokens`` is a device tensor, or host ids sent up as
        uint16 and as int32, each its own case."""
        if isinstance(tokens, torch.Tensor):
            variants = [(str(tokens.dtype).split(".")[-1], tokens)]
        else:
            t = np.asarray(tokens, np.int64)
            variants = [(name, torch.from_numpy(t.astype(dt)).to(dev))
                        for name, dt in (("uint16", np.uint16), ("int32", np.int32))]
        for name, T in variants:
            before = onpair_decode.decode_tokens.launches
            out, olen = onpair_decode.decode_tokens(T, n, dd.mat16, lens8, max_out)
            rout, rlen = ref.decode_tokens_ref(T, n, dd.mat16, lens8, max_out)
            label = f"{case} ({name})"
            check_equal("decode_tokens", f"{label} out_len", olen, rlen)
            check_equal("decode_tokens", f"{label} bytes", out, rout)
            launched = onpair_decode.decode_tokens.launches - before
            if launched != (1 if min(n, T.numel()) > 0 else 0):
                raise AssertionError(f"decode_tokens {label}: {launched} launches")
        return T, min(max(n, 0), T.numel()), int(olen)

    lens8 = store._device.lens8  # the lengths the paths hand the kernel
    rng = np.random.default_rng(SEED + 2)
    N = dictionary.num_entries
    tile = onpair_decode._STREAM_TILE
    for T in (1, tile - 1, tile, tile + 1, 34 * tile + 5):
        t = rng.integers(0, N, T)
        stream_pair(t, T, int(host_lens[t].sum()), f"T={T}")
    t = rng.integers(0, N, 3000)
    full = int(host_lens[t].sum())
    stream_pair(t, 1700, int(host_lens[t[:1700]].sum()), "n_tokens < T")
    stream_pair(t, 3000, full - 1000, "max_out < out_len")
    stream_pair(t, 3000, full + 99, "max_out > out_len (zero filled)")
    stream_pair(t, 3000, full + 4099, "max_out 4,099 bytes past out_len (zero filled)")
    stream_pair(t, 3000, 0, "max_out = 0")
    stream_pair(np.resize(sixteen, 5000), 5000, 16 * 5000, "all 16-byte tokens")
    stream_pair(np.resize(ones, 5000), 5000, 5000, "all 1-byte tokens")
    t = rng.integers(0, N, 1 << 20)
    stream_pair(t, t.size, int(host_lens[t].sum()), "2^20 random ids")
    stream_pair(np.zeros(0, np.int32), 0, 8, "T=0")
    stream_pair(np.zeros(9, np.int32), 0, 8, "n_tokens=0")
    # the mirror, and ranges of it that start at every alignment of a
    # 16-byte vector (as uint16, and the same tokens as int32 at an offset)
    starts = res.host_starts
    mirror_i32 = ref.token_ids(res_tokens).to(torch.int32)
    for k in range(8):
        lo = int(np.flatnonzero(starts % 8 == k)[0])
        a, b = int(starts[lo]), int(starts[lo + 3000])
        size = int(res.raw_lens[lo : lo + 3000].sum())
        stream_pair(res_tokens[a:b], b - a, size, f"mirror strings {lo}-{lo + 3000} "
                    f"from token {a}")
        stream_pair(mirror_i32[a:b], b - a, size, f"the same tokens as int32 from {a}")
    odd = int(np.flatnonzero(starts[: -STRINGS_PER_SEGMENT - 1] % 2 == 1)[0])
    a, b = int(starts[odd]), int(starts[odd + STRINGS_PER_SEGMENT])
    range_pair = stream_pair(res_tokens[a:b], b - a,
                             int(res.raw_lens[odd : odd + STRINGS_PER_SEGMENT].sum()),
                             f"a mirror range of {STRINGS_PER_SEGMENT} strings from "
                             f"odd token {a}")
    whole_pair = stream_pair(res_tokens, res_tokens.numel(), raw_bytes, "the whole mirror")
    full_u16 = torch.from_numpy(pay_tokens.copy()).to(dev)  # as decode_all sends it
    full_pairs = {name: stream_pair(tk, tk.numel(), raw_bytes, f"full stream ({name})")
                  for name, tk in (("uint16", full_u16),
                                   ("int32", ref.token_ids(full_u16).to(torch.int32)))}
    # thousands of calls back to back on two streams, each held against its
    # plain output on the card: the look-back scratch never leaks between calls
    cases = []
    for T_, n_, m_ in (full_pairs["int32"], range_pair, whole_pair,
                       (res_tokens[1:40001], 40000, None), (res_tokens[3:9], 6, None)):
        m_ = m_ if m_ is not None else int(host_lens[T_.cpu().numpy().astype(np.int64)].sum())
        cases.append((T_, n_, m_, *ref.decode_tokens_ref(T_, n_, dd.mat16, lens8, m_)))
    side = torch.cuda.Stream()
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    side_bad = torch.zeros((), dtype=torch.int64, device=dev)
    n_b2b = 0
    for i in range(2000):
        T_, n_, m_, want, want_len = cases[i % len(cases)]
        out, olen = onpair_decode.decode_tokens(T_, n_, dd.mat16, lens8, m_)
        bad += (out != want).sum() + (olen != want_len)
        n_b2b += 1
        if i % 4 == 0:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                T2, n2, m2, want2, wlen2 = cases[(i // 4) % len(cases)]
                out2, olen2 = onpair_decode.decode_tokens(T2, n2, dd.mat16, lens8, m2)
                side_bad += (out2 != want2).sum() + (olen2 != wlen2)
                n_b2b += 1
            torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if int(bad) or int(side_bad):
        raise AssertionError(f"decode_tokens back to back: {int(bad)} + {int(side_bad)} "
                             "bytes differ from the plain version")
    # the kernel reads uint8 lengths only: int32 ones are refused, unlaunched
    before = onpair_decode.decode_tokens.launches
    try:
        onpair_decode.decode_tokens(full_u16, 8, dd.mat16, dd.lens, 64)
        raise AssertionError("decode_tokens took int32 lengths on the card")
    except ValueError:
        pass
    if onpair_decode.decode_tokens.launches != before:
        raise AssertionError("decode_tokens launched on int32 lengths")
    # (inputs, token bytes)
    stream_inputs = {
        f"full stream, uint16 (T={full_u16.numel()})": (full_pairs["uint16"], 2),
        f"full stream, int32 (T={full_u16.numel()})": (full_pairs["int32"], 4),
        f"a mirror range of {STRINGS_PER_SEGMENT} strings (uint16, T={b - a})":
            (range_pair, 2),
        f"scan(0, n) from the mirror (uint16, T={res_tokens.numel()})": (whole_pair, 2),
    }
    log("parity", f"decode_tokens == plain, exact (all bytes and out_len), uint16 and "
        f"int32 tokens: T=1, {tile - 1}, {tile}, {tile + 1} and {34 * tile + 5} "
        "(look-back past a warp of tiles), n_tokens < T, max_out below, at 0 and "
        "past out_len, all 16-byte and all 1-byte tokens, 2^20 random ids, mirror "
        "ranges from every token alignment of a 16-byte vector, a "
        f"{STRINGS_PER_SEGMENT}-string mirror range from an odd token, the whole "
        "mirror, the full-corpus stream; T=0 and n_tokens=0 return without a "
        "launch; int32 lengths refused without a launch; "
        f"{n_b2b} calls back to back over five shapes on two streams, "
        "every one exact")

    # ------------------------------------------------------------ 7. numbers
    log("numbers", f"[{card}] encode {throughput_mib_s(raw_bytes, encode_s):.3f} "
        f"MiB/s ({raw_bytes} B in {encode_s:.3f} s, {launches['encode_batch']} "
        f"launches); ratio {corpus.ratio:.4f}")
    used_all = np.unique(pay_tokens)
    n_long_all = int((dictionary.lens[used_all] > 8).sum())
    flat_bytes = (raw_bytes + 8 * n_all + 4 * pay_tokens.size
                  + 16 * (used_all.size - n_long_all) + 40 * n_long_all)
    enc_acts = windows["encode"][1]
    if "encode_batch" in enc_acts:
        log("numbers", f"[{card}] encode_batch over the whole corpus (the encode "
            f"window, torch.profiler): {enc_acts['encode_batch'][0]} launches, "
            f"{enc_acts['encode_batch'][1] * 1e3:.4f} ms device; bound "
            f"{corpus_bound_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms summed over the "
            f"launches ({corpus_bound_bytes} B: padded rows in, padded token rows "
            f"out); {flat_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms for the bytes of "
            f"the strings, lengths, tokens, counts and table records alone "
            f"({flat_bytes} B)")
    lat_ms = np.asarray(lat) * 1e3
    log("numbers", f"[{card}] multiget {n_all / multiget_s:.1f} lookups/s, "
        f"{throughput_mib_s(decoded_bytes, multiget_s):.3f} MiB/s ({len(batches)} "
        f"batches of {MULTIGET_IDS} ids in {multiget_s:.3f} s; p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms, p99 {np.percentile(lat_ms, 99):.3f} "
        f"ms per batch)")
    log("numbers", f"[{card}] decode_all {throughput_mib_s(raw_bytes, decode_all_s[0]):.1f} "
        f"MiB/s ({raw_bytes} B, {pay_tokens.size} tokens in one launch, "
        f"{decode_all_s[0] * 1e3:.2f} ms; three more calls: "
        + ", ".join(f"{throughput_mib_s(raw_bytes, s):.1f}" for s in decode_all_s[1:]) + " MiB/s)")
    log("numbers", f"[{card}] decode_all in a fresh process (after one 1-token "
        "decode; no encode): " + ", ".join(
            f"{throughput_mib_s(raw_bytes, s):.1f}" for s in fresh["seconds"])
        + " MiB/s (first call, three more)")
    log("numbers", f"[{card}] scan in segment-sized ranges "
        f"{throughput_mib_s(raw_bytes, scan_seg_s):.1f} MiB/s, {n_all / scan_seg_s:.0f} "
        f"strings/s ({n_seg} ranges in {scan_seg_s:.3f} s); scan(0, n) "
        f"{throughput_mib_s(raw_bytes, scan_all_s):.1f} MiB/s, {n_all / scan_all_s:.0f} "
        f"strings/s ({scan_all_s:.3f} s)")
    log("numbers", f"[{card}] extend {throughput_mib_s(extend_raw, extend_s):.3f} MiB/s, "
        f"{(n_all - half) / extend_s:.0f} strings/s ({n_all - half} strings, "
        f"{extend_raw} B in batches of {EXTEND_BATCH}, {extend_s:.3f} s, seals "
        "off-thread)")
    log("numbers", f"[{card}] compact train_s {report['train_s']}, total_s "
        f"{report['total_s']}, ratio_before {report['ratio_before']}, "
        f"ratio_after {report['ratio_after']} ({report['n_strings']} strings)")

    def rows_touched(tokens: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        valid = torch.arange(tokens.shape[1], device=dev) < n[:, None]
        return torch.unique(tokens[valid].to(torch.int64))

    per_shape = []

    def measure(name, shape, n_launch, fn, plain_fn, plain_reps, nbytes):
        device, seen = device_ms(fn, KERNEL_SYMBOLS[name], 200)
        call = cuda_ms(fn, 200)
        if device is None:
            log("numbers", f"torch.profiler saw no device time for {name}; its "
                "time below is the per-call time from CUDA events")
        # one kernel symbol a wrapper call (the profiler may miss events)
        mine = {k: v for k, v in seen.items() if KERNEL_SYMBOLS[name] in k}
        log("numbers", f"{name} {shape}: device activity over 200 calls under "
            f"torch.profiler: {seen}")
        if len(mine) > 1 or sum(mine.values()) > 200 or (
                name == "decode_tokens" and "Memset" in seen):
            raise AssertionError(f"{name} {shape}: more than one kernel, or a memset, "
                                 f"a call: {seen}")
        per_shape.append({
            "name": name, "shape": shape, "launches": n_launch,
            "ms": call if device is None else device, "call_ms": call,
            "method": "CUDA events" if device is None else "torch.profiler",
            "plain_ms": cuda_ms(plain_fn, plain_reps, warmup=1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes})

    for label, ((tk, st, ids_t, off_t, size), nbytes, n_launch) in rows_inputs.items():
        measure("decode_compact", label, n_launch,
                lambda: onpair_decode.decode_rows(tk, st, off_t, size, dd.mat16,
                                                  dd.lens, ids=ids_t),
                lambda: ref.decode_rows_ref(tk, st, off_t, size, dd.mat16, dd.lens,
                                            ids=ids_t), 5, nbytes)
    # the padded contract at the store's former (256, cap) shapes, on no path
    # since the multiget launches rows; kept beside the earlier design's times
    for cap, (T, N_) in dec_inputs.items():
        out, olen = onpair_decode.decode_compact(T, N_, dd.mat16, dd.lens)
        measure("decode_compact", f"padded (256, {cap})", 0,
                lambda: onpair_decode.decode_compact(T, N_, dd.mat16, dd.lens),
                lambda: ref.decode_batch_ref(T, N_, dd.mat16, dd.lens), 5,
                T.numel() * 4 + N_.numel() * 4 + rows_touched(T, N_).numel() * 20
                + int(olen.sum()) + olen.numel() * 4)
    for label, (D, L, n_launch) in enc_inputs.items():
        cap = D.shape[1] - 16
        toks, n = onpair_encode.encode_batch(D, L, dd, cap)
        measure("encode_batch", label, n_launch,
                lambda: onpair_encode.encode_batch(D, L, dd, cap),
                lambda: ref.encode_batch_ref(D, L, dd, cap), 1,
                encode_bytes(D, L, toks, n))
    # launches on the paths: decode_all's calls are full streams of uint16;
    # scan(0, n) and the scan after compact() each read the whole mirror;
    # every other stream launch reads a range of at most a segment's strings
    whole_launches = 2
    stream_launches = {"full stream, uint16": stream_full_launches,
                       "full stream, int32": 0, "scan(0, n)": whole_launches,
                       "a mirror range": counts.total["decode_tokens"]
                       - stream_full_launches - whole_launches}
    for shape, ((T, n, out_len), tok_bytes) in stream_inputs.items():
        # tokens read once, each distinct dictionary row (16 B) and uint8
        # length once, the decoded bytes and out_len written once
        measure("decode_tokens", shape,
                next(v for k, v in stream_launches.items() if shape.startswith(k)),
                lambda: onpair_decode.decode_tokens(T, n, dd.mat16, lens8, out_len),
                lambda: ref.decode_tokens_ref(T, n, dd.mat16, lens8, out_len), 3,
                tok_bytes * n + (16 + 1)
                * torch.unique(ref.token_ids(T[:n])).numel() + out_len + 8)
    for r in per_shape:
        log("numbers", f"[{card}] {r['name']} {r['shape']}: {r['ms'] * 1e3:.2f} us "
            f"device time per call ({r['method']}), {r['call_ms'] * 1e3:.2f} us "
            f"per wrapper call (CUDA events over 200 calls), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bytes']} B at 3.35 TB/s); {r['launches']} launches on the "
            "paths (L2 warm)")
    kernels = []
    for name, source, replaces in (
            ("decode_compact", "src/repro_torch/kernels/csrc/onpair_decode.cu",
             "src/repro/kernels/onpair_decode.py:116"),
            ("encode_batch", "src/repro_torch/kernels/csrc/onpair_encode.cu",
             "src/repro/kernels/onpair_encode.py:67"),
            ("decode_tokens", "src/repro_torch/kernels/csrc/onpair_decode_stream.cu",
             "src/repro/kernels/onpair_decode.py:40")):
        rows = [r for r in per_shape if r["name"] == name]
        total = sum(r["launches"] for r in rows)  # > 0: every kernel launched

        def weighted(key, rows=rows, total=total):
            # mean per launch over the paths' mix of shapes
            return sum(r["launches"] * r[key] for r in rows) / total
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts.total[name],
                        # any difference from the plain version raised above
                        "max_abs_err": 0, "parity": "exact",
                        "ms": weighted("ms"), "plain_ms": weighted("plain_ms"),
                        "bound_ms": weighted("bound_ms"), "bound_by": "bytes",
                        "library_ms": None, "call_ms": weighted("call_ms"),
                        "path_ms": path_ms.get(name)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def decode_all_probe(path: str) -> int:
    """``chip_smoke.py --decode-all-probe FILE``: time four calls of
    ``Decoder.decode_all`` on the dictionary and corpus saved in FILE, in
    this fresh process, after one 1-token decode that loads the kernels;
    print the seconds and the first output's sha256 as one JSON line."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.api import CompressedCorpus
    from repro_torch.core.codec import Decoder
    from repro_torch.core.packed import PackedDictionary

    z = np.load(path)
    blob, lens = z["entries"].tobytes(), z["entry_lens"].tolist()
    ends = np.cumsum(lens).tolist()
    entries = [blob[e - n : e] for e, n in zip(ends, lens)]
    decoder = Decoder(PackedDictionary.build(entries), device=torch.device("cuda"))
    corpus = CompressedCorpus(payload=z["payload"], offsets=z["offsets"],
                              raw_bytes=int(z["raw_bytes"]),
                              meta={"compressor": "onpair16"})
    decoder._device.decode_stream(np.zeros(1, np.int32))
    seconds, digest = [], None
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = decoder.decode_all(corpus)
        seconds.append(time.perf_counter() - t0)
        digest = digest or hashlib.sha256(whole).hexdigest()
    print(json.dumps({"seconds": seconds, "sha256": digest}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--decode-all-probe"]:
        sys.exit(decode_all_probe(sys.argv[2]))
    sys.exit(main())
