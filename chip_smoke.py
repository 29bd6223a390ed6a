"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds the two CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
then drives the port's main path at a realistic size: 32 MiB of synthetic
book titles (seed 0), an OnPair16 dictionary trained on an 8 MiB sample, the
whole corpus encoded on the card through ``Encoder`` (the encode kernel),
and every string read back once through ``CompressedStringStore.multiget``
(the decode kernel) in shuffled 1024-id batches. Afterwards it holds each
kernel against its plain PyTorch version on the card, exactly, at the main
path's shapes and at edge cases, times both with CUDA events, and prints the
numbers beside the card's name and power limit. Every failure raises; the
last line is the result the caller reads. Without a card it exits non-zero
and prints no result. Imports nothing of JAX and nothing of ``repro``.
"""

from __future__ import annotations

import json
import math
import os
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
PARITY_STRINGS = 4096
ENCODE_WINDOW = 1 << 16  # strings encoded under the profiler
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
KERNEL_SYMBOLS = {"decode_compact": "decode_compact_kernel",
                  "encode_batch": "encode_batch_kernel"}


def device_ms(fn, symbol: str, reps: int) -> float | None:
    """Mean device time per launch of the CUDA kernel named ``symbol``, from
    torch.profiler: the kernel alone, without the host's launch overhead.
    None when the profiler recorded no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if symbol in ev.key and ev.count:
            total_us = getattr(ev, "self_device_time_total", 0)
            if total_us > 0:
                return total_us / ev.count / 1e3
    return None


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


def check_equal(name: str, case: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Raise unless a kernel's output equals its plain version's exactly."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max() \
            if got.shape == want.shape else "shape"
        raise AssertionError(f"{name} {case}: kernel differs from the plain "
                             f"version ({tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max abs err {diff})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.codec import Encoder
    from repro_torch.core.lpm import lpm_from_entries
    from repro_torch.core.metrics import throughput_mib_s
    from repro_torch.core.onpair import OnPairConfig, train_dictionary
    from repro_torch.core.packed import PackedDictionary
    from repro_torch.data.synth import load_dataset
    from repro_torch.kernels import _build, onpair_decode, onpair_encode, ops, ref
    from repro_torch.store import CompressedStringStore

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
    log("data", f"book_titles: {len(strings)} strings, {raw_bytes} B, mean "
        f"{raw_bytes / len(strings):.1f} B, made in {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 4. the main path
    onpair_decode.decode_compact.launches = 0
    onpair_encode.encode_batch.launches = 0
    ref.decode_batch_ref.calls = 0
    ref.encode_batch_ref.calls = 0
    ref_batches_before = ops._DECODE_BATCHES["ref"].value
    cuda_batches_before = ops._DECODE_BATCHES["cuda"].value

    t0 = time.perf_counter()
    trained = train_dictionary(strings, OnPairConfig.onpair16(
        sample_bytes=SAMPLE_BYTES, seed=SEED))
    dictionary = PackedDictionary.build(trained.entries)
    train_s = time.perf_counter() - t0
    log("main", f"trained {dictionary.num_entries} entries from "
        f"{trained.scanned_bytes} sample bytes in {train_s:.1f} s; tables "
        f"{dictionary.resident_bytes} B")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = Encoder(dictionary, device=dev).encode(strings)
    encode_s = time.perf_counter() - t0
    store = CompressedStringStore(dictionary, corpus, device=dev, cache_bytes=0)

    order = np.random.default_rng(SEED).permutation(len(strings))
    batches = [order[i : i + MULTIGET_IDS].tolist()
               for i in range(0, len(order), MULTIGET_IDS)]
    lat, answers = [], []
    t0 = time.perf_counter()
    for ids in batches:
        t1 = time.perf_counter()
        answers.append(store.multiget(ids))
        lat.append(time.perf_counter() - t1)
    multiget_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for ids, got in zip(batches, answers):  # checked outside the timed loop
        for i, s in zip(ids, got):
            if s != strings[i]:
                raise AssertionError(f"multiget({i}) != source string")
    del answers

    launches = {"decode_compact": onpair_decode.decode_compact.launches,
                "encode_batch": onpair_encode.encode_batch.launches}
    log("main", f"launches {launches}; plain versions called "
        f"{ref.decode_batch_ref.calls + ref.encode_batch_ref.calls} times; "
        "repro_kernel_decode_batches_total{path=cuda} +"
        f"{ops._DECODE_BATCHES['cuda'].value - cuda_batches_before}, "
        f"{{path=ref}} +{ops._DECODE_BATCHES['ref'].value - ref_batches_before}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if ref.decode_batch_ref.calls or ref.encode_batch_ref.calls:
        raise AssertionError("the main path called a plain version on the card")
    if ops._DECODE_BATCHES["ref"].value != ref_batches_before:
        raise AssertionError("repro_kernel_decode_batches_total{path=ref} moved")
    if store.stats.decoded_strings != len(strings):
        raise AssertionError("not every string was decoded exactly once")
    decoded_bytes = store.stats.decoded_bytes

    # launches per shape, recomputed from the inputs, must add up to the counts
    enc_lens = np.fromiter((max(len(s), 1) for s in strings), np.int64, len(strings))
    caps_enc = sorted(set(ops._ENCODE_LEN_BUCKETS) | {
        store._device._encode_cap(int(enc_lens.max()))})
    enc_shapes = {}
    lo = 0
    for cap in caps_enc:
        k = int(((enc_lens > lo) & (enc_lens <= cap)).sum())
        enc_shapes[cap] = math.ceil(k / store._device.encode_pad_batch)
        lo = cap
    counts = corpus.token_counts()
    caps_dec = [int(c) for c in store.bucket_caps]
    dec_shapes = dict.fromkeys(caps_dec, 0)
    for ids in batches:
        b = np.searchsorted(store.bucket_caps, counts[ids], side="left")
        for j, cap in enumerate(caps_dec):
            dec_shapes[cap] += math.ceil(int((b == j).sum()) / store.batch_size)
    if sum(enc_shapes.values()) != launches["encode_batch"] or \
            sum(dec_shapes.values()) != launches["decode_compact"]:
        raise AssertionError(f"launches per shape {enc_shapes} {dec_shapes} do "
                             f"not add up to {launches}")

    # -------------------------------------- 5. device share of the main path
    # a steady window of each path, driven as above but under torch.profiler
    # (after the counts were read): kernel device time over the window's wall
    encoder = Encoder(dictionary, device=dev)
    windows = {"encode": device_window(lambda: encoder.encode(strings[:ENCODE_WINDOW])),
               "multiget": device_window(
                   lambda: [store.multiget(ids) for ids in batches[:MULTIGET_WINDOW]])}
    path_ms = {}
    for path, (wall, acts) in windows.items():
        if not acts:
            log("device", f"[{card}] {path}: torch.profiler recorded no device "
                "time; busy share not measured")
            continue
        busy = sum(sec for _, sec in acts.values())
        log("device", f"[{card}] {path} window (torch.profiler, {wall:.3f} s wall): "
            + "; ".join(f"{k} {n} x, {sec:.4f} s" for k, (n, sec) in sorted(acts.items()))
            + f"; device busy {busy / wall:.2%}, kernels of the path "
            f"{sum(acts.get(k, (0, 0.0))[1] for k in KERNEL_SYMBOLS) / wall:.2%}")
        for name in KERNEL_SYMBOLS:
            if name in acts:
                path_ms[name] = acts[name][1] / acts[name][0] * 1e3
    log("device", f"mean device ms per launch over the windows' mix of shapes: {path_ms}")

    # ---------------------------------------------------- 6. kernel parity
    dd = store._device.dd
    lpm = lpm_from_entries(dictionary.entries)

    def encode_pair(batch, cap, max_tokens, case):
        """Kernel == plain version (whole outputs) == the host LPM parse."""
        data, lens = ops.pack_strings(batch, pad_len=cap)
        D, L = torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)
        got = onpair_encode.encode_batch(D, L, dd, max_tokens)
        want = ref.encode_batch_ref(D, L, dd, max_tokens)
        toks, n = got[0].cpu().numpy(), got[1].cpu().numpy()
        ptoks, pn = want[0].cpu().numpy(), want[1].cpu().numpy()
        for i, s in enumerate(batch):
            host = lpm.parse(s)[:max_tokens]
            if toks[i, : n[i]].tolist() != host or ptoks[i, : pn[i]].tolist() != host:
                raise AssertionError(
                    f"encode_batch {case}, row {i} {s!r}: host parse {host}, "
                    f"kernel {toks[i, : n[i]].tolist()}, plain "
                    f"{ptoks[i, : pn[i]].tolist()}")
        check_equal("encode_batch", f"{case} tokens", got[0], want[0])
        check_equal("encode_batch", f"{case} n_tokens", got[1], want[1])
        return D, L

    def long_strings(n, lo, hi):
        joined = (b" / ".join(strings[i : i + 8]) for i in range(0, 80 * n, 8))
        return [s[:hi] for s in joined if len(s) > lo][:n]

    encode_pair(EDGE, 512, 512, "edge strings")
    encode_pair(EDGE[:6] + strings[:64], 128, 5, "max_tokens=5 truncation")
    encode_pair([], 32, 32, "B=0")
    enc_inputs = {}
    lo = 0
    for cap in caps_enc:
        batch = [s for s in strings if lo < max(len(s), 1) <= cap][:PARITY_STRINGS]
        if len(batch) < 64:  # too few such titles: join some up to this cap
            batch = long_strings(PARITY_STRINGS, lo, cap)
        if len(batch) < 64:
            raise AssertionError(f"no parity strings for encode cap {cap}")
        encode_pair(batch, cap, cap, f"{len(batch)} corpus strings, cap {cap}")
        enc_inputs[cap] = encode_pair(batch[:64], cap, cap, f"(64, {cap}+16)")
        lo = cap
    log("parity", f"encode_batch == plain == host LPM parse, exact: edge strings, max_tokens "
        f"truncation, B=0, up to {PARITY_STRINGS} corpus strings in each cap "
        f"{caps_enc} and the main path's (64, cap+16) shapes")

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

    sixteen = np.flatnonzero(dictionary.lens == 16).astype(np.int32)[:8]
    decode_pair(np.zeros((0, 4), np.int32), np.zeros(0, np.int32), "B=0")
    decode_pair(np.zeros((1, 4), np.int32), np.zeros(1, np.int32), "n_tokens=0")
    decode_pair(np.array([[65], [66]], np.int32), np.array([1, 0], np.int32), "T=1")
    decode_pair(np.tile(sixteen, (4, 1)), np.array([8, 7, 1, 0], np.int32),
                "16-byte rows")
    dec_inputs = {}
    bucket_of = np.searchsorted(store.bucket_caps, counts, side="left")
    for j, cap in enumerate(caps_dec):
        members = np.flatnonzero(bucket_of == j)[:PARITY_STRINGS]
        for c0 in range(0, len(members), store.batch_size):
            lists = [np.asarray(corpus.string_tokens(int(i)), np.int32)
                     for i in members[c0 : c0 + store.batch_size]]
            pair = decode_pair(*ops.pack_token_matrix(
                lists, pad_tokens=cap, pad_batch=store.batch_size), f"(256, {cap})")
            dec_inputs.setdefault(cap, pair)
    log("parity", "decode_compact == plain, exact: B=0, n_tokens=0, T=1, 16-byte "
        f"rows, up to {PARITY_STRINGS} corpus strings per store bucket at "
        f"(256, cap) for caps {caps_dec}")

    # ------------------------------------------------------------ 7. numbers
    log("numbers", f"[{card}] encode {throughput_mib_s(raw_bytes, encode_s):.3f} "
        f"MiB/s ({raw_bytes} B in {encode_s:.3f} s, {launches['encode_batch']} "
        f"launches); ratio {corpus.ratio:.4f}")
    lat_ms = np.asarray(lat) * 1e3
    log("numbers", f"[{card}] multiget {len(strings) / multiget_s:.1f} lookups/s, "
        f"{throughput_mib_s(decoded_bytes, multiget_s):.3f} MiB/s ({len(batches)} "
        f"batches of {MULTIGET_IDS} ids in {multiget_s:.3f} s; p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms, p99 {np.percentile(lat_ms, 99):.3f} "
        f"ms per batch)")

    def rows_touched(tokens: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        valid = torch.arange(tokens.shape[1], device=dev) < n[:, None]
        return torch.unique(tokens[valid].to(torch.int64))

    per_shape = []

    def measure(name, shape, n_launch, fn, plain_fn, plain_reps, nbytes):
        device = device_ms(fn, KERNEL_SYMBOLS[name], 200)
        call = cuda_ms(fn, 200)
        if device is None:
            log("numbers", f"torch.profiler saw no device time for {name}; its "
                "time below is the per-call time from CUDA events")
        per_shape.append({
            "name": name, "shape": shape, "launches": n_launch,
            "ms": call if device is None else device, "call_ms": call,
            "method": "CUDA events" if device is None else "torch.profiler",
            "plain_ms": cuda_ms(plain_fn, plain_reps, warmup=1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes})

    for cap, (T, N) in dec_inputs.items():
        out, olen = onpair_decode.decode_compact(T, N, dd.mat16, dd.lens)
        measure("decode_compact", f"(256, {cap})", dec_shapes[cap],
                lambda: onpair_decode.decode_compact(T, N, dd.mat16, dd.lens),
                lambda: ref.decode_batch_ref(T, N, dd.mat16, dd.lens), 5,
                T.numel() * 4 + N.numel() * 4 + rows_touched(T, N).numel() * 20
                + int(olen.sum()) + olen.numel() * 4)
    long_tok = torch.from_numpy(dictionary.lens > 8).to(dev)
    for cap, (D, L) in enc_inputs.items():
        toks, n = onpair_encode.encode_batch(D, L, dd, cap)
        used = rows_touched(toks, n)
        n_long = int(long_tok[used].sum())
        # inputs read once, outputs written once, and one table record per
        # distinct token emitted: a 16-byte short-table slot, or a prefix slot
        # + bucket bounds + a suffix record (40 B) for a token longer than 8 B
        measure("encode_batch", f"(64, {cap}+16)", enc_shapes[cap],
                lambda: onpair_encode.encode_batch(D, L, dd, cap),
                lambda: ref.encode_batch_ref(D, L, dd, cap), 1,
                D.numel() + L.numel() * 4 + toks.numel() * 4 + n.numel() * 4
                + 16 * (used.numel() - n_long) + 40 * n_long)
    for r in per_shape:
        log("numbers", f"[{card}] {r['name']} {r['shape']}: {r['ms'] * 1e3:.2f} us "
            f"device time per launch ({r['method']}), {r['call_ms'] * 1e3:.2f} us "
            f"per wrapper call (CUDA events over 200 calls), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bytes']} B at 3.35 TB/s); {r['launches']} launches on the "
            "main path (L2 warm)")
    kernels = []
    for name, source, replaces in (
            ("decode_compact", "src/repro_torch/kernels/csrc/onpair_decode.cu",
             "src/repro/kernels/onpair_decode.py:116"),
            ("encode_batch", "src/repro_torch/kernels/csrc/onpair_encode.cu",
             "src/repro/kernels/onpair_encode.py:67")):
        rows = [r for r in per_shape if r["name"] == name]
        total = sum(r["launches"] for r in rows)  # > 0: every kernel launched

        def weighted(key, rows=rows, total=total):
            # mean per launch over the main path's mix of shapes
            return sum(r["launches"] * r[key] for r in rows) / total
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
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


if __name__ == "__main__":
    sys.exit(main())
