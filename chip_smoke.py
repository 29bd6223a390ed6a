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
   ``compact()`` (all three);
5. persistence and reverse lookup: the read store saved and opened again
   (here and in a fresh process; the device mirror rebuilt from the
   corpus), every string read back; ``locate_batch`` of sampled strings and
   absent ones (the encode kernel for the queries, the stream kernel for
   the first call's index build), saved again with ``index.npz`` and
   reopened without a rebuild; ``scan_prefix`` against a sorted filter of
   the source (one decode launch per probed string); and a writable store
   with an unsealed tail and four cold segments saved, opened (here and in
   a fresh process), appended to and ``compact(dir_path=)``-ed into its
   next versioned generation, which folds the tier back;
6. the cold tier: twelve of the read store's segments demoted off-thread
   (each read through the stream kernel, re-encoded as RLZ on the host and
   taken off the device mirror), every string read back by multiget (the
   cold ones from RLZ on the host, the hot ones in one decode launch a
   call) and by scan (one stream launch per run of hot segments), one
   segment promoted by a read burst and the rest by ``tier_op``, after
   which the mirror equals that of a store never tiered on the card; four
   segments demoted again, saved, and opened here and in a fresh process,
   then located in and prefix-scanned;
7. serving: the read store written as four shards by ``save_sharded`` and
   opened by ``ShardedStringStore.open`` on one shared device codec (one
   upload of the tables, checked), every id read through the router (one
   decode launch per shard a call touches), ``scan(0, n)`` (one stream
   launch a shard), ``scan_prefix`` and ``locate_batch`` against the flat
   store's answers, a segment of each shard demoted, read back from RLZ and
   promoted, 5,000 strings extended onto the tail shard, saved, reopened
   and read back; then ``StoreService`` over the read store (point lookups
   from eight threads, 1,024-id requests from four, each drained batch one
   decode launch) and over a writable store (appends interleaved with
   reads), its counters read after ``close()`` joined the worker; the
   sharded reopen after the save of appends builds the device tables once;
8. codecs: the registry (OnPair16 alone device-decodable); the host batch
   parse of the read phase's artifact (``registry.codec_from_artifact``)
   equal to the encode kernel's ``Encoder.encode``, payload and offsets, over
   the whole corpus; every registered codec trained, compressed,
   decompressed and randomly accessed at 4 MiB on the host, with the paper's
   ratio order; stores of unbounded OnPair and BPE built by codec name on the
   host (every string back, ``backend == "numpy"``, no kernel launch), an
   explicit device for BPE and stores of FSST, LZ-block and raw refused; a
   writable unbounded-OnPair store appended to, compacted and opened in a
   fresh process; and an OnPair16 store built by codec name on the card, its
   launches recomputed;
9. wire: the read store's four shards behind four ``repro_torch.net``
   ``ShardServer``s in this process (writable, on the card) and read through
   a ``DistributedStringStore`` over loopback: every id in the read path's
   shuffled calls (one decode launch per shard a call touches, equal to the
   servers' service batches), the same sweep under the profiler, ``get()``
   from eight threads, ``scan(0, n)`` in 4,096-string RPCs (one stream
   launch each) while a second connection reads, ``locate_batch`` and
   ``scan_prefix`` equal to the flat store's, 5,000 strings extended onto
   the tail shard and read back; then one shard served by ``python -m
   repro_torch.net`` in a child process on the card, read through a router,
   its ``/metrics`` counts equal to the requests sent, killed, restarted on
   its port and read again through the same router, which reconnects. The
   wire runs after the kernels' parity checks and timings: its profiled
   sweep's launches come from the servers' threads, and no other profiled
   window follows it;
10. clients and load: ``repro_torch.client.connect`` over ``file://`` (the
   read store saved), ``mut://`` (a writable copy), ``shard://`` (its four
   shards) and ``tcp://`` (a ``repro_torch.loadgen.LocalCluster`` of four
   ``python -m repro_torch.net`` child processes on the card, one a shard),
   every id read back through each in the read path's shuffled calls (one
   decode launch a batch of the client-owned service; a call per shard
   touched for ``shard://``; in each child, its ``/metrics`` decode counter
   on the card equal to its service's batches of reads, and none on the
   host), the stats key sets equal across the four; ``get_async`` from
   eight threads (coalesced by the client), ``repro_torch.loadgen``'s closed
   loop and an open loop at half its rate over the cluster (the servers'
   histograms read by the stats RPC and by scrape, equal), ``python -m
   repro_torch.loadgen --url`` attached to it, and 5,000 appends
   group-committed onto the tail shard's child and read back. No profiled
   window: the host clock times it;
11. the LM serving path (``repro_torch.launch.serve``'s LM role): every
   architecture at its smoke config in fp32 on the card against the same
   weights on the host (TF32 off; logits within the CPU tests' 1e-4, equal
   greedy ids, forward, prefill and 8 decode steps past ``max_seq``), then
   in bf16 on the card (shapes, finite); mamba2-780m at full width in bf16
   through ``serve_lm --doc-ids 3 17 4242 --max-new 16``, the store built on
   the encode kernel (its launches recomputed) and the prompts fetched by
   one multiget (one decode launch), equal to the corpus strings, every
   logit finite; the same weights in fp32 on the card and on the host, and
   prefill against decode on the card, each within 1e-3 of the largest
   logit; one more bf16 decode step of the launcher's run under the
   profiler, beside its bound. ``--lm-probe SRC`` times that step alone
   with ``repro_torch`` imported from SRC (two trees in one call);
12. the LM training path (``repro_torch.launch.train``): every architecture
   at its smoke config in fp32 (TF32 off), a step on the card against the
   same state on the host (the loss, every gradient, the updated parameters
   and both moments within 1e-4 of each leaf's largest value; q8 moments
   within one quantum; 2 microbatches), then a bf16 step on the card,
   finite; the launcher in child processes on the card: 9 steps with a
   checkpoint at step 6, then 9 resumed from step 6 (its step-6 loss equal
   to the uninterrupted run's, the later ones within 1e-2), a child sent
   SIGTERM saving and exiting 0, the card's checkpoint
   restored on the host to equal leaves; mamba2-780m at full width in bf16
   through ``train_lm`` (batch 8 x seq 256, 8 steps, nothing saved): the
   step's wall, tokens/s and peak device memory, and one more step under
   the profiler beside its bound; the same weights in fp32, card against
   host, loss and gradients within 1e-3. No kernel of the port is on this
   path.

Every string each path returns is checked against its source, each path's
encode launches are recomputed from the bucketed encode's chunking (per
length cap, chunks of up to ``encode_pad_batch`` strings and
``ops._ENCODE_CHUNK_BYTES`` padded bytes), its decode launches from its
multiget calls (per shard touched, on the sharded store) and its stream
launches from its scan ranges. Afterwards it profiles a window of each path (device busy
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
numbers beside the card's name and power limit. Every profiled window's
kernel records must number the wrappers' launches in it (a short window
runs again, at most three times, and then fails). Every failure
raises; the last line is the result the caller reads. Without a card it
exits non-zero and prints no result. Imports nothing of JAX and nothing of
``repro``.
"""

from __future__ import annotations

import bisect
import cProfile
import faulthandler
import hashlib
import json
import os
import pstats
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
LOCATE_HITS = 20_000  # sampled source strings located on the opened store (50,000 before the train phase)
LOCATE_MISSES = 10_000  # absent strings (a source string and one more byte)
PREFIXES = 10  # scan_prefix prefixes of 1-8 bytes
PAGED_PREFIXES = 1  # of them, paginated to the end (3 before the train phase)
PREFIX_LIMIT = 100
WRITABLE_STRINGS = 1 << 18  # the persist phase's writable store, before extend
WRITABLE_EXTEND = 5_000  # strings appended before the save and after the open
WRITABLE_COLD = [3, 20, 40, 64]  # its segments demoted before the save
TIER_COLD = list(range(0, 192, 16))  # the read store's segments demoted off-thread
TIER_SAVE_COLD = [1, 50, 100, 195]  # demoted again before the tiered save
SERVE_SHARDS = 4  # shards the serve phase writes the read store as
SERVE_COLD = [1, 10, 20, 48]  # each shard's local segment demoted (mod its count)
SERVE_EXTEND = 5_000  # strings appended to the tail shard and through the service
SERVE_CLIENTS = 8  # threads of service get() calls
SERVE_MULTIGET_CLIENTS = 4  # threads of 1,024-id service multiget requests
SERVE_GET_IDS = 20_000  # shuffled ids the get() threads share (40,000 before the train phase)
WINDOW_TRIES = 3  # profiled runs of a window until one sees every launch
CODEC_DATA_BYTES = 2 << 20  # the host codecs' corpus: their parse runs in Python
#: training samples of the host codecs (BPE and FSST train in Python loops)
CODEC_SAMPLES = {"onpair": 1 << 19, "onpair16": 1 << 19, "bpe": 1 << 17,
                 "fsst": 1 << 17}
CODEC_ACCESS = 1_000  # seeded random access calls per codec
CODEC_APPENDS = 5_000  # strings appended to the writable unbounded-OnPair store (10,000 before the train phase)
WIRE_GET_IDS = 4_000  # shuffled ids the wire phase's get() threads share (8,000 before the train phase)
WIRE_LOCATE_HITS = 10_000  # of the persist phase's hits, located over the wire
WIRE_LOCATE_MISSES = 1_000  # of its misses, located first (every index builds)
WIRE_PREFIXES = 3  # of its prefixes, the three with the fewest probes
WIRE_READY_S = 120.0  # deadline for the subprocess server's readiness line
CLIENT_GET_IDS = 5_000  # shuffled ids the client phase's get_async threads share (10,000 before the train phase)
CLIENT_APPENDS = 5_000  # strings of 1-32 B appended through the client
LOADGEN_S = 3.0  # seconds of each loadgen loop, closed then open at half its rate (5 before the train phase)
CLI_S = 2.0  # seconds of the loadgen CLI's run against the cluster (3 before the train phase)
PROBE_CALLS = 200  # 1,024-id calls a layout of --cluster-probe reads
LM_ARCH = "mamba2-780m"  # the launcher's default architecture, at full width
LM_DOC_IDS = [3, 17, 4242]  # prompts fetched from the launcher's store
LM_MAX_NEW = 16  # greedy decode steps of the launcher's run
LM_SMOKE_DECODE = 8  # decode steps of each smoke config, card against host
LM_SMOKE_MAX_SEQ = 20  # their cache length: the steps run past it
LM_SMOKE_TOL = 1e-4  # the CPU tests' whole-model tolerance (rtol and atol)
LM_FP32_DECODE = 4  # decode steps of the full-width fp32 comparisons
LM_GATE = 1e-3  # max abs logit error / max |logit| at full width in fp32
LM_PROBE_STEPS = 32  # timed decode steps of --lm-probe, after 2 untimed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16, NVIDIA's data sheet
TRAIN_TOL = 1e-4  # smoke configs card vs host, of each leaf's largest |value|
TRAIN_MB_RTOL = 1e-3  # a step of 2 microbatches against one batch, loss
TRAIN_RESUME_RTOL = 1e-6  # a resumed run's first loss against the uninterrupted run's
TRAIN_LATER_RTOL = 1e-2  # its later bf16 losses against the uninterrupted run's
TRAIN_STEP0 = 50  # the smoke states' step: the schedule's factor is 0 at step 0
TRAIN_STEPS = 8  # full-width steps; the step's wall is the median of steps 2-8
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_GATE = 1e-3  # full width fp32 card vs host, of each leaf's largest |value|
TRAIN_CHILD_S = 300.0  # deadline of each launcher child
TRAIN_CHILD_ARGS = ["--smoke", "--batch", "2", "--seq", "32", "--data-mib", "1"]
DIST_STEPS = 4  # full-width steps of train_lm --mesh 1,1, held to the train phase's first ones
DIST_COMPRESS_CALLS = 3  # timed compressed_pmean calls over the full-width gradient tree
DIST_SAMPLE_LEAVES = 3  # of its leaves, compressed again on gloo on the host
TP_MESH = (1, 2)  # (data, model) of the dist phase's tensor-parallel ranks, both on the card
#: their smoke configs (fp32): name -> (arch, the changes the CPU tests make); the
#: last three attend on a rank's query heads (H divides over model, K does not)
#: and on its half of the queries (H does not divide; H = K in qwen1.5's)
TP_SMOKE = {"mamba2-780m": ("mamba2-780m", {}), "yi-9b": ("yi-9b", {"n_kv_heads": 2}),
            "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
            "mixtral-8x22b": ("mixtral-8x22b", {}), "whisper-medium": ("whisper-medium", {}),
            "yi-9b-kv1": ("yi-9b", {"n_kv_heads": 1}),
            "gemma2-2b-h3": ("gemma2-2b", {"n_heads": 3, "n_kv_heads": 1}),
            "qwen1.5-4b-h3": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 3})}
TP_MESH_DP = (2, 2)  # four more ranks on the card, started with those two
#: their smoke configs: 3 experts, which do not divide over model, so the MoE
#: capacity slots split over data; and yi-9b's widened until its MLP leaves
#: reach the FSDP threshold of 2^20 entries, run with FSDP (``TP_FSDP``)
TP_SMOKE_DP = {"mixtral-8x22b-e3": ("mixtral-8x22b", {"n_experts": 3}),
               "yi-9b-fsdp": ("yi-9b", {"d_model": 256, "d_ff": 4096, "n_kv_heads": 2})}
TP_FSDP = {"yi-9b-fsdp"}  # the configs whose state is placed with fsdp=True
#: and yi-9b at its full width (d_model 4,096, d_ff 11,008, 32 query and 4 KV
#: heads, vocab 64,000) in fp32, cut in depth to 4 blocks: FSDP on those ranks
#: too, its peak device memory held to a pass that gathers the whole tree
TP_FSDP_FULL = ("yi-9b-full", "yi-9b", 4)
#: and that FSDP config again with 8-bit AdamW moments (its train steps only):
#: each rank updates the q8 rows it holds (``repro_torch.optim.q8_shard``)
TP_Q8 = ("yi-9b-fsdp-q8", "yi-9b-fsdp")
#: and ``TP_FSDP_FULL``'s config with them: at full width a rank works its
#: larger leaves' rows in many passes of ``q8_shard.CHUNK`` positions
TP_Q8_FULL = "yi-9b-full-q8"
#: and, on those ranks, a batch of one (smaller than the data axes: the KV
#: caches' sequence splits over data where it divides, ``long_500k``'s layout;
#: each rank attends on its slice, the softmax combined over data): five
#: smoke configs, a full cache (jamba, with SSM and MoE layers), an 8-slot SWA
#: ring (h2o-danube), cross caches (whisper's encoder, llama-3.2-vision's 8
#: vision tokens) and local and global layers (gemma2), a TP_SEQ_PROMPT-token
#: prompt into TP_SEQ_MAX slots and TP_SEQ_STEPS decode steps, across the
#: ring's wrap and the clamp at the last slot
TP_SEQ_SPLIT = ("jamba-1.5-large-398b", "h2o-danube-1.8b", "whisper-medium", "gemma2-2b",
                "llama-3.2-vision-90b")
TP_SEQ_PROMPT, TP_SEQ_MAX, TP_SEQ_STEPS = 16, 20, 6
#: and h2o-danube-1.8b at full width in fp32 cut to 4 layers, its weights drawn
#: on the card: a 48-token prompt into 64 slots (32 a data rank), 8 decode steps
TP_SEQ_FULL = ("h2o-danube-full", "h2o-danube-1.8b", 4)
TP_SEQ_FULL_PROMPT, TP_SEQ_FULL_MAX, TP_SEQ_FULL_STEPS = 48, 64, 8
#: and mixtral-8x22b at full width (d_model 6,144, d_ff 16,384) with 3
#: experts, in fp32, cut to its layers, with FSDP, its weights drawn on the
#: card: a prefill and train batch of TP_BATCH x TP_MOE_SEQ = 4,096 tokens,
#: so that the capacity's dispatch takes the reference's index-gather form
#: (the payload scatter at a decode step's TP_BATCH tokens)
TP_MOE_FULL = ("mixtral-full-e3", "mixtral-8x22b", 1)
TP_MOE_SEQ = 1024
TP_BATCH, TP_SEQ = 4, 16  # their prefill batch; the cache holds TP_SEQ + TP_DECODE
TP_DECODE = 4  # decode steps after each prefill
TP_TRAIN_STEPS = 2  # train steps from step 50
TP_TOL = 1e-4  # smoke ranks against the card's one-device run, of the largest |value|
TP_CHILD_S = 300.0  # deadline of the two ranks, from their start
EDGE = [b"", b"a", b"ab", b"abcdefgh", b"abcdefghi", b"x" * 100,
        bytes(range(256)), b"\x00" * 20, b"abracadabra abracadabra"]


#: seconds from the script's start at which each phase logged first
FIRST_LOG: dict[str, float] = {}
T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    FIRST_LOG.setdefault(phase, time.perf_counter() - T_START)
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


def device_ms(fn, name: str, reps: int
              ) -> tuple[tuple[float | None, dict[str, list]], dict[str, int], str]:
    """Mean device time per call of ``fn`` spent in the kernel of wrapper
    ``name``, from torch.profiler: the kernel alone, without the host's
    launch overhead (None when the profiler recorded no device time for
    it), over ``reps`` calls in one :func:`device_window` (the caller warmed
    ``fn`` up); and the window's device activity (count and seconds of each
    kernel by wrapper, copies, sets). Also the kernel records per wrapper
    and a note, for :func:`checked`."""
    (_, acts), seen, note = device_window(lambda: [fn() for _ in range(reps)])
    sec = acts.get(name, [0, 0.0])[1]
    return ((sec / reps * 1e3 if sec > 0 else None), acts), seen, note


#: the profiler's marker around a window: copies, sets and other kernels
#: count only inside its span, so the warm-up's fall outside it. The port's
#: own kernels count wherever the trace dates them: only ``fn`` launches
#: them, and the profiler dates some records up to about 2 ms across the
#: marker's edges (PERF.md §7)
WINDOW_MARK = "chip_smoke.window"
#: the idle seconds before and after the marker under the profiler. The
#: profiler drops the device records of a trace's first launches: late in a
#: long process, every kernel of its first 1.4 ms, the warm-up's and the
#: window's first (PERF.md §7); so the window starts well after them
WINDOW_PAD_S = 0.1


def kernel_key(name: str) -> str | None:
    """The wrapper a device record's kernel name belongs to, if any."""
    return next((n for n, sym in KERNEL_SYMBOLS.items() if sym in name), None)


def checked(what: str, run, wrappers: dict) -> tuple:
    """Run a profiled window until torch.profiler saw every launch the
    kernel wrappers counted in it, at most ``WINDOW_TRIES`` times, and fail
    if it never did: a short count is never accepted. ``run()`` returns
    (its result, the profiler's kernel records per wrapper name, a note on
    the records dated outside the window, or None). Returns the
    result and the number of runs it took."""
    for attempt in range(1, WINDOW_TRIES + 1):
        before = {k: w.launches for k, w in wrappers.items()}
        result, seen, note = run()
        counted = {k: w.launches - before[k] for k, w in wrappers.items()}
        if all(seen.get(k, 0) == n for k, n in counted.items()):
            if note:
                log("device", f"{what}, run {attempt}: every launch seen; {note}")
            return result, attempt
        log("device", f"{what}, run {attempt}: torch.profiler saw {seen}, the "
            f"wrappers counted {counted}; {note or 'none dated outside the window'}")
    raise AssertionError(f"{what}: torch.profiler's kernel records differed from "
                         f"the wrappers' launches in all {WINDOW_TRIES} runs")


def device_window(fn) -> tuple[tuple[float, dict[str, list]], dict[str, int], str]:
    """Run ``fn`` once under torch.profiler, after a one-element warm-up
    launch and ``WINDOW_PAD_S`` before the window's marker (and as long
    after it). Returns the window's wall seconds
    and, per device activity (each port kernel by wrapper, anywhere in the
    trace; copies, sets and other kernels in the marker's span), its count
    and summed device seconds (empty when the profiler saw no device time);
    the kernel records per wrapper; and a note on those the trace dates
    outside the span (before its start, by how far, or after its end) — for
    :func:`checked`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        time.sleep(WINDOW_PAD_S)
    events = prof.events()
    mark = next(ev.time_range for ev in events
                if ev.name == WINDOW_MARK and ev.device_type == DeviceType.CPU)
    acts: dict[str, list] = {}
    early: list[float] = []
    late = 0
    for ev in events:
        # the marker's own range shows on the device timeline too: not work
        if ev.device_type != DeviceType.CUDA or ev.name == WINDOW_MARK:
            continue
        key = kernel_key(ev.name)
        inside = mark.start <= ev.time_range.start <= mark.end
        if key is None and not inside:
            continue
        if key is not None and ev.time_range.start < mark.start:
            early.append(mark.start - ev.time_range.start)
        elif key is not None and not inside:
            late += 1
        key = key or ("copies" if "Memcpy" in ev.name else
                      "sets" if "Memset" in ev.name else "other kernels")
        entry = acts.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += ev.time_range.elapsed_us() / 1e6
    seen = {k: acts[k][0] for k in KERNEL_SYMBOLS if k in acts}
    note = (f"kernel records dated outside the window: {len(early)} before its "
            f"start (up to {max(early, default=0):.1f} us before), {late} after "
            "its end") if early or late else None
    return (wall, acts), seen, note


def lm_step_bytes(params: dict, cache: dict, cfg, batch: int) -> int:
    """Bytes one decode step must move: every weight of the decoder read
    once (with a separate head, only the batch's rows of the embedding),
    every cache leaf read once, the SSM state and conv tails written back
    and one slot of each self-attention KV cache written. Every expert of
    a MoE layer counts as read (the launcher's mamba2-780m has none)."""
    from repro_torch.models.transformer import block_plan

    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def leaves(tree: dict):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from ((f"{k}/{kk}", vv) for kk, vv in leaves(v))
            else:
                yield k, v

    total = sum(nbytes(v) for k, v in leaves(params)
                if not k.startswith("enc_blocks/"))
    if not cfg.tie_embeddings:
        emb = params["embed"]
        total -= nbytes(emb) - batch * emb.shape[1] * emb.element_size()
    for i, sub in enumerate(block_plan(cfg)):
        for k, v in cache["blocks"][f"l{i}"].items():
            total += nbytes(v)  # read once
            if sub.kind == "ssm":
                total += nbytes(v)  # written back
            elif sub.kind != "cross" and k in ("k", "v"):
                total += nbytes(v) // v.shape[2]  # one slot written
    return total


def train_step_bound(state: dict, cfg, n_tokens: int) -> tuple[float, str, float, int]:
    """The least time one train step of ``state`` over ``n_tokens`` tokens
    could take: the larger of its operations over the bf16 dense peak and
    its bytes over HBM's rate. Operations: 6 a parameter a token (the
    forward and backward of every weight; the embedding counts only as the
    tied head's matmul, the lookup as nothing). Bytes: each parameter read
    twice (forward, backward), its gradient written and read once, the
    parameter written once, both moments read and written once (AdamW);
    activations count nothing, since what they cost depends on the
    implementation. Returns (ms, "operations" or "bytes", operations,
    bytes)."""
    from repro_torch.tree import leaves

    params = leaves(state["params"])
    n_embed = state["params"]["embed"].numel()
    n_matmul = sum(p.numel() for p in params) - n_embed
    if cfg.tie_embeddings:
        n_matmul += n_embed
    flops = 6.0 * n_matmul * n_tokens
    nbytes = sum(6 * p.numel() * p.element_size() for p in params)
    nbytes += sum(2 * t.numel() * t.element_size()
                  for t in leaves({"m": state["opt"]["m"], "v": state["opt"]["v"]}))
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


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


def digest(vals: list[bytes]) -> dict:
    """Count, sha256 of the concatenation and sha256 of the lengths of a
    list of strings: equal digests mean equal lists."""
    lens = np.fromiter(map(len, vals), np.int64, len(vals))
    return {"n": len(vals), "sha256": hashlib.sha256(b"".join(vals)).hexdigest(),
            "lens_sha256": hashlib.sha256(lens.tobytes()).hexdigest()}


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


def raise_if_clients_failed(what: str, threads, errors: list) -> None:
    """Raise if a client thread is still alive or failed, after writing every
    thread's stack to stderr: a stalled service worker shows where it stood."""
    if any(t.is_alive() for t in threads) or errors:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise AssertionError(f"{what} hung or failed: {errors[:1]}")


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
    from repro_torch.distributed import ShardedStringStore, plan_shards, save_sharded
    from repro_torch.kernels import (_build, crafted, onpair_decode, onpair_encode,
                                     ops, ref)
    from repro_torch.store import (CompressedStringStore, MutableStringStore,
                                   StoreService, tier_op)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    # the dry-run of the train phase's full-width step, traced on the host
    # in a child while the early phases run (its counts are of shapes)
    dry = start_dryrun_probe()
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

    def stream_calls(lo: int, hi: int, sealed: int, cold=()) -> int:
        """Stream launches of scan(lo, hi): one per run of hot segments of
        its sealed strings (segments of STRINGS_PER_SEGMENT; those in
        ``cold`` decode from RLZ, unlaunched) and one for its tail strings,
        each when it holds tokens."""
        runs, a = [], lo
        while a < min(hi, sealed):
            k = a // STRINGS_PER_SEGMENT
            b = min(hi, sealed, (k + 1) * STRINGS_PER_SEGMENT)
            if k not in cold and runs and runs[-1][1] == a:
                runs[-1][1] = b
            elif k not in cold:
                runs.append([a, b])
            a = b
        runs.append([max(lo, sealed), hi])
        return sum(a < b and tok_off[b] > tok_off[a] for a, b in runs)

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

    # ------------------------------------------------------------ 4.5 persist
    # save -> open of the read store (here and in a fresh process), locate
    # and scan_prefix on it, save -> open with its index.npz, and save ->
    # open -> extend -> compact(dir_path=) of a writable store with an
    # unsealed tail; every file under a temporary directory
    counts.start()
    payload_sha = hashlib.sha256(corpus.payload).hexdigest()[:16]

    def hot_calls(id_batches, sealed: int, cold) -> int:
        """Decode launches of multigets with the cache off: one for a call
        with a sealed id outside the ``cold`` segments (cold ones decode
        from RLZ on the host)."""
        cold = np.asarray(sorted(cold), np.int64)
        return sum(bool(((ids < sealed) & ~np.isin(ids // STRINGS_PER_SEGMENT, cold)).any())
                   for ids in map(np.asarray, id_batches))

    def serve_all(st, want: list[bytes], path: str) -> tuple[int, int, int]:
        """Every id of ``st`` through shuffled 1,024-id multigets and
        scan(0, n), each == its source string. Returns the calls' decode
        launches (one for hot sealed ids, one more for tail ids), those for
        the tail alone, and scan(0, n)'s stream launches."""
        n = st.n_strings
        cold = set(st.tier.cold) if st.tier is not None else set()
        perm = np.random.default_rng(SEED).permutation(n)
        calls = [perm[i : i + MULTIGET_IDS] for i in range(0, n, MULTIGET_IDS)]
        for ids in calls:
            check_strings(f"{path} multiget", st.multiget(ids), [want[j] for j in ids])
        tail_calls = sum(bool((ids >= st.n_sealed).any()) for ids in calls)
        check_strings(f"{path} scan(0, n)", st.scan(0, n), want)
        return (hot_calls(calls, st.n_sealed, cold) + tail_calls, tail_calls,
                stream_calls(0, n, st.n_sealed, cold))

    def fresh_open(path: str, kind: str, want: list[bytes], payload: str,
                   cold=()) -> dict:
        """Open the store saved at ``path`` in a fresh process, which reads
        every string as ``serve_all`` does; its digests must be the source's,
        its payload's sha256 prefix ``payload`` and its cold segments
        ``cold``."""
        probe = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--open-probe", path, kind],
                               capture_output=True, text=True, timeout=600)
        if probe.returncode != 0:
            raise RuntimeError(f"open of the {kind} store in a fresh process failed:\n"
                               f"{probe.stderr[-4000:]}")
        got = json.loads(probe.stdout.strip().splitlines()[-1])
        expect = digest(want)
        for key in ("multiget", "scan"):
            if got[key] != expect:
                raise AssertionError(f"{kind} store opened in a fresh process: its "
                                     f"{key} differs from the source strings")
        if got["payload_sha256"] != payload:
            raise AssertionError(f"{kind} store opened in a fresh process: payload "
                                 f"sha256 {got['payload_sha256']} != {payload}")
        if got["cold"] != sorted(cold) or bool(got["cold_lookups"]) != bool(cold):
            raise AssertionError(f"{kind} store opened in a fresh process: cold "
                                 f"segments {got['cold']}, expected {sorted(cold)}")
        return got

    expect_encode = 0  # encode launches of the phase, recomputed from its inputs

    def encode_calls(batch: list[bytes]) -> int:
        return len(encode_launch_shapes(batch, ops._ENCODE_LEN_BUCKETS, pad_batch,
                                        chunk_bytes))

    with tempfile.TemporaryDirectory() as tmp:
        # the read store of 4.1: save, open here, open in a fresh process
        rdir = os.path.join(tmp, "read")
        t0 = time.perf_counter()
        store.save(rdir)
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opened = CompressedStringStore.open(rdir, device=dev)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        opened_sha = hashlib.sha256(opened.corpus.payload).hexdigest()[:16]
        if opened_sha != payload_sha:
            raise AssertionError(f"opened store: payload sha256 {opened_sha} != "
                                 f"the build's {payload_sha}")
        served_launches, _, served_scans = serve_all(opened, strings, "opened read store")
        rfresh = fresh_open(rdir, "read", strings, payload_sha)

        # locate: hits are sampled source strings, misses a sampled string
        # and one more byte, absent from the corpus; the first call (misses,
        # so it probes every segment) builds every segment's index
        first_id: dict[bytes, int] = {}
        for i, s in enumerate(strings):
            first_id.setdefault(s, i)
        rng = np.random.default_rng(SEED + 4)
        hit_q = [strings[i] for i in rng.integers(0, n_all, LOCATE_HITS)]
        want_hits = [first_id[s] for s in hit_q]
        miss_q = []
        for i in rng.integers(0, n_all, 2 * LOCATE_MISSES):
            s = strings[i] + bytes([int(i) % 251])
            if s not in first_id:
                miss_q.append(s)
            if len(miss_q) == LOCATE_MISSES:
                break

        def locate_all(st) -> tuple[float, float, float]:
            """(seconds of the first call, of the hits, of the other
            misses); every answer checked."""
            t0 = time.perf_counter()
            misses = st.locate_batch(miss_q[:MULTIGET_IDS])
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            hits = [r for i in range(0, LOCATE_HITS, MULTIGET_IDS)
                    for r in st.locate_batch(hit_q[i : i + MULTIGET_IDS])]
            t_hits = time.perf_counter() - t0
            t0 = time.perf_counter()
            misses += [r for i in range(MULTIGET_IDS, LOCATE_MISSES, MULTIGET_IDS)
                       for r in st.locate_batch(miss_q[i : i + MULTIGET_IDS])]
            t_misses = time.perf_counter() - t0
            if hits != want_hits:
                bad = next(k for k, (h, w) in enumerate(zip(hits, want_hits)) if h != w)
                raise AssertionError(f"locate: hit {bad} answered {hits[bad]}, the "
                                     f"lowest id of that string is {want_hits[bad]}")
            if any(m is not None for m in misses):
                raise AssertionError("locate: an absent string was found")
            return t_first, t_hits, t_misses

        loc_batches = [miss_q[i : i + MULTIGET_IDS] for i in range(0, LOCATE_MISSES,
                                                                   MULTIGET_IDS)]
        loc_batches += [hit_q[i : i + MULTIGET_IDS] for i in range(0, LOCATE_HITS,
                                                                  MULTIGET_IDS)]
        before = onpair_decode.decode_tokens.launches
        loc1 = locate_all(opened)
        build_launches = onpair_decode.decode_tokens.launches - before
        if len(opened._seg_indexes) != n_seg or build_launches != n_seg:
            raise AssertionError(f"locate built {len(opened._seg_indexes)} indexes in "
                                 f"{build_launches} stream launches, expected {n_seg}")
        snap_loc = opened.stats_snapshot()
        if (snap_loc["locates"], snap_loc["locate_hits"]) != (
                LOCATE_HITS + LOCATE_MISSES, LOCATE_HITS):
            raise AssertionError(f"locate counters {snap_loc['locates']}, "
                                 f"{snap_loc['locate_hits']}")
        expect_encode += sum(map(encode_calls, loc_batches))

        # save again, index.npz included; the reopened store answers the
        # same queries from the saved indexes, with no stream launch
        idir = os.path.join(tmp, "indexed")
        t0 = time.perf_counter()
        opened.save(idir)
        save2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reopened = CompressedStringStore.open(idir, device=dev)
        torch.cuda.synchronize()
        open2_s = time.perf_counter() - t0
        before = onpair_decode.decode_tokens.launches
        loc2 = locate_all(reopened)
        if len(reopened._seg_indexes) != n_seg or \
                onpair_decode.decode_tokens.launches != before:
            raise AssertionError("the store opened with index.npz rebuilt an index")
        expect_encode += sum(map(encode_calls, loc_batches))
        disk = {name: os.path.getsize(os.path.join(idir, name))
                for name in sorted(os.listdir(idir))}
        del reopened

        # scan_prefix, cache off: every probed string is one decode launch
        ordered = sorted(zip(strings, range(n_all)))

        def prefix_expect(p: bytes) -> list[tuple[int, bytes]]:
            k = bisect.bisect_left(ordered, (p,))
            out = []
            while k < n_all and ordered[k][0].startswith(p):
                out.append((ordered[k][1], ordered[k][0]))
                k += 1
            return out

        long_ids = np.flatnonzero(np.fromiter(map(len, strings), np.int64, n_all) >= 8)
        prefixes = [strings[int(i)][: 1 + k % 8] for k, i in enumerate(
            np.random.default_rng(SEED + 5).choice(long_ids, PREFIXES, replace=False))]
        prefix_calls = []  # (launches, seconds) per scan_prefix call

        def prefix_call(p: bytes, after=None) -> list:
            before = onpair_decode.decode_compact.launches
            t0 = time.perf_counter()
            got = opened.scan_prefix(p, limit=PREFIX_LIMIT, after=after)
            prefix_calls.append((onpair_decode.decode_compact.launches - before,
                                 time.perf_counter() - t0))
            return got

        expected = {p: prefix_expect(p) for p in prefixes}
        for p in prefixes:
            if prefix_call(p) != expected[p][:PREFIX_LIMIT]:
                raise AssertionError(f"scan_prefix({p!r}) differs from a sorted "
                                     "filter of the source strings")
        # pages to the end for the prefixes with the fewest matches past one
        # page (each page probes every segment)
        paged = sorted(prefixes, key=lambda p: (len(expected[p]) <= PREFIX_LIMIT,
                                                len(expected[p])))[:PAGED_PREFIXES]
        n_pages = 0
        for p in paged:
            pages, after = [], None
            while True:
                page = prefix_call(p, after)
                n_pages += 1
                if not page:
                    break
                pages += page
                after = (page[-1][1], page[-1][0])
            if pages != expected[p]:
                raise AssertionError(f"scan_prefix({p!r}) paginated differs from a "
                                     "sorted filter of the source strings")
        if opened.stats.prefix_scans != len(prefix_calls):
            raise AssertionError("scan_prefix: the prefix_scans counter is off")
        prefix_launches = sum(n for n, _ in prefix_calls)
        del ordered  # the opened store stays for the profiled windows (5.)

        # the writable store: the first WRITABLE_STRINGS strings, an extend
        # that leaves a tail, save -> open (here and in a fresh process) ->
        # extend -> compact(dir_path=) -> open
        wn, wx = WRITABLE_STRINGS, WRITABLE_EXTEND
        wcut = int(corpus.offsets[wn])
        w = MutableStringStore(
            dictionary, CompressedCorpus(payload=corpus.payload[:wcut],
                                         offsets=corpus.offsets[: wn + 1].copy(),
                                         raw_bytes=sum(map(len, strings[:wn])),
                                         meta=dict(corpus.meta)),
            device=dev, config=config, strings_per_segment=STRINGS_PER_SEGMENT,
            cache_bytes=0)
        w.extend(strings[wn : wn + wx])
        expect_encode += encode_calls(strings[wn : wn + wx])
        w.seal_barrier()
        w_sealed = w.n_sealed
        w_sha = hashlib.sha256(w.snapshot_corpus().payload).hexdigest()[:16]
        wtier = w.enable_tiering(promote_above=1e9,
                                 workdir=os.path.join(tmp, "writable-tier"))
        if any(wtier.demote(si) is None for si in WRITABLE_COLD):
            raise AssertionError("writable store: a demotion did not happen")
        wdir = os.path.join(tmp, "writable")
        t0 = time.perf_counter()
        w.save(wdir)
        wsave_s = time.perf_counter() - t0
        wcold = sorted(n for n in os.listdir(os.path.join(wdir, "v0000"))
                       if n.startswith("cold-"))
        if wcold != [f"cold-{si:04d}.rlz" for si in WRITABLE_COLD]:
            raise AssertionError(f"writable store: saved cold files {wcold}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w2 = MutableStringStore.open(wdir, device=dev)
        torch.cuda.synchronize()
        wopen_s = time.perf_counter() - t0
        if (w2.n_sealed, w2.n_strings) != (w_sealed, wn + wx) or \
                w2.drift.snapshot() != w.drift.snapshot() or \
                sorted(w2.tier.cold) != WRITABLE_COLD:
            raise AssertionError("writable store: the open lost its tail, drift "
                                 "window or cold segments")
        del w
        launched, w_tail_calls, scanned_ = serve_all(w2, strings[: wn + wx],
                                                     "opened writable store")
        served_launches += launched
        served_scans += scanned_
        wfresh = fresh_open(wdir, "writable", strings[: wn + wx], w_sha, WRITABLE_COLD)
        ids = w2.extend(strings[wn + wx : wn + 2 * wx])
        expect_encode += encode_calls(strings[wn + wx : wn + 2 * wx])
        w2.seal_barrier()
        n0 = wn + 2 * wx
        if ids != list(range(wn + wx, n0)) or w2.n_sealed != n0 // STRINGS_PER_SEGMENT \
                * STRINGS_PER_SEGMENT or [s.base_id for s in w2.segments.segments] != \
                list(range(0, w2.n_sealed, STRINGS_PER_SEGMENT)):
            raise AssertionError("writable store: appends after the open sealed off "
                                 "the segment boundaries")
        w2_sealed = w2.n_sealed
        compact_scans = sum(
            stream_calls(lo, min(lo + STRINGS_PER_SEGMENT, n0), w2_sealed, WRITABLE_COLD)
            for lo in range(0, n0, STRINGS_PER_SEGMENT))
        wrep = w2.compact(dir_path=wdir)
        expect_encode += encode_calls(strings[:n0])
        if wrep["dir"] != wdir or sorted(os.listdir(wdir)) != ["current.json", "v0001"]:
            raise AssertionError(f"compact(dir_path=): {wrep}, {sorted(os.listdir(wdir))}")
        if w2.tier.cold:
            raise AssertionError("compact(dir_path=) left cold segments")
        del w2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w3 = MutableStringStore.open(wdir, device=dev)
        torch.cuda.synchronize()
        wopen2_s = time.perf_counter() - t0
        if w3.version_id != 1 or w3.tier is not None:
            raise AssertionError("the compacted generation did not open as v0001, "
                                 "untiered")
        launched, tail_calls_, scanned_ = serve_all(w3, strings[:n0],
                                                    "compacted writable store")
        served_launches += launched
        served_scans += scanned_
        w_tail_calls += tail_calls_
        del w3

    persist = counts.end("persist", ["encode_batch", "decode_compact", "decode_tokens"])
    served = n_all + (wn + wx) + n0
    expect_pd = served_launches + prefix_launches
    # scans: the three served stores' scan(0, n) (the opened writable one's
    # split at its cold segments), the index build (a launch a segment), the
    # writable store's demotions (one read each), compact()'s chunks (none
    # for a cold segment's)
    expect_ps = served_scans + n_seg + len(WRITABLE_COLD) + compact_scans
    if (persist["decode_compact"], persist["decode_tokens"], persist["encode_batch"]) \
            != (expect_pd, expect_ps, expect_encode):
        raise AssertionError(
            f"persist: launches {persist}, expected decode_compact {expect_pd}, "
            f"decode_tokens {expect_ps}, encode_batch {expect_encode}")
    pf_n = np.asarray([n for n, _ in prefix_calls])
    pf_ms = np.asarray([t for _, t in prefix_calls]) * 1e3
    first_n, first_ms = pf_n[:PREFIXES], pf_ms[:PREFIXES]
    matches = [len(expected[p]) for p in paged]
    log("persist", f"[{card}] read store ({n_all} strings, {n_seg} segments): save "
        f"{save_s:.3f} s, open {open_s:.3f} s in this process; open in a fresh process "
        f"{rfresh['open_s']:.3f} s (after {rfresh['init_s']:.3f} s of CUDA start and "
        f"kernel load); every id by multiget and scan(0, n) == the source in both; "
        f"payload sha256 {payload_sha} (== the build's)")
    log("persist", f"[{card}] index build on the first locate call: {loc1[0]:.3f} s "
        f"({build_launches} stream launches for {n_seg} segments, 1,024 absent "
        "queries)")
    log("persist", f"[{card}] locate in calls of {MULTIGET_IDS}: {LOCATE_HITS} hits "
        f"{LOCATE_HITS / loc1[1]:.1f} queries/s, {LOCATE_MISSES - MULTIGET_IDS} "
        f"misses {(LOCATE_MISSES - MULTIGET_IDS) / loc1[2]:.1f} queries/s; opened "
        f"again with index.npz (0 stream launches): first call {loc2[0]:.3f} s, hits "
        f"{LOCATE_HITS / loc2[1]:.1f} queries/s, misses "
        f"{(LOCATE_MISSES - MULTIGET_IDS) / loc2[2]:.1f} queries/s; every hit the "
        "lowest id of its string, every miss None")
    log("persist", f"[{card}] scan_prefix (limit {PREFIX_LIMIT}, cache off), each "
        f"call == a sorted filter of the source: {PREFIXES} prefixes of 1-8 bytes "
        f"{first_ms.mean():.1f} ms a call (p50 {np.percentile(first_ms, 50):.1f}, max "
        f"{first_ms.max():.1f}), decode_compact launches a call mean "
        f"{first_n.mean():.1f}, min {first_n.min()}, max {first_n.max()} (one per "
        f"probed string); {n_pages} pages to the end of {len(paged)} prefixes "
        f"({matches} matches) {pf_ms[PREFIXES:].mean():.1f} ms and "
        f"{pf_n[PREFIXES:].mean():.1f} launches a page; {prefix_launches} launches "
        "in all")
    log("persist", f"[{card}] on disk after the second save: " + ", ".join(
        f"{k} {v} B" for k, v in disk.items()) + f"; save with index.npz {save2_s:.3f} "
        f"s, open {open2_s:.3f} s")
    log("persist", f"[{card}] writable store ({wn} strings + {wx} appended, "
        f"{wn + wx - w_sealed} in the tail): save {wsave_s:.3f} s, open {wopen_s:.3f} s, "
        f"open in a fresh process {wfresh['open_s']:.3f} s (segments {WRITABLE_COLD} "
        f"cold, from their RLZ files); {wx} more appended after "
        f"the open seal on the {STRINGS_PER_SEGMENT}-string boundaries; "
        f"compact(dir_path=) total_s {wrep['total_s']} (train_s {wrep['train_s']}), "
        f"ratio before {wrep['ratio_before']}, after {wrep['ratio_after']}; v0001 "
        f"written without cold files, v0000 pruned; opened again in {wopen2_s:.3f} s; "
        f"{served} strings served == the source")

    # ---------------------------------------------------------- 4.6 the tier
    # TIER_COLD demoted off-thread, as users run it (each demotion reads its
    # segment through the stream kernel and takes its tokens off the mirror);
    # every string read back; promotion by a read burst and by tier_op; four
    # segments demoted again, saved, and opened here and in a fresh process
    counts.start()
    t_phase = time.perf_counter()
    spc = STRINGS_PER_SEGMENT
    res = store.resident
    mem0, dev0, pay0 = store.memory_bytes, store.resident_device_bytes, res.n_bytes
    tdir = tempfile.mkdtemp(prefix="chip-smoke-tier-")  # demotions, then the save
    tier = store.enable_tiering(promote_above=1e9, workdir=os.path.join(tdir, "work"))
    reports = []
    demote = tier.demote

    def demote_and_report(si):  # the worker drops what demote returns
        reports.append(demote(si))
        return reports[-1]

    tier.demote = demote_and_report
    t0 = time.perf_counter()
    for si in TIER_COLD:
        tier.schedule_demote(si)
    tier.join()
    demote_wall = time.perf_counter() - t0
    tier.demote = demote
    if sorted(tier.cold) != TIER_COLD or len(reports) != len(TIER_COLD) \
            or None in reports:
        raise AssertionError(f"tier: {sorted(tier.cold)} cold after join(), "
                             f"{len(TIER_COLD)} scheduled: {TIER_COLD}")
    cold_set = set(TIER_COLD)
    seg_ids = np.arange(n_all) // spc
    cold_ids = np.flatnonzero(np.isin(seg_ids, TIER_COLD))
    hot_ids = np.flatnonzero(~np.isin(seg_ids, TIER_COLD))
    cold_payload = sum(store.segments.segments[si].payload_bytes for si in TIER_COLD)
    mem1, dev1, pay1 = store.memory_bytes, store.resident_device_bytes, res.n_bytes
    if pay0 - pay1 != cold_payload or mem0 - mem1 != cold_payload + sum(
            store.segments.segments[si].offsets.nbytes for si in TIER_COLD):
        raise AssertionError(f"tier: the mirror's payload fell by {pay0 - pay1} B and "
                             f"memory_bytes by {mem0 - mem1} B; the cold segments "
                             f"hold {cold_payload} B of payload")

    # every id: the read path's shuffled batches, then cold ids only and as
    # many calls of hot ids only; each call with a hot id is one launch
    before_dc = onpair_decode.decode_compact.launches
    lookups0 = store.stats.cold_lookups
    t0 = time.perf_counter()
    answers = [store.multiget(ids) for ids in batches]
    mixed_s = time.perf_counter() - t0
    for ids, got in zip(batches, answers):
        check_strings("tiered multiget", got, [strings[i] for i in ids])
    sweep_launches = onpair_decode.decode_compact.launches - before_dc
    if sweep_launches != hot_calls(batches, n_all, cold_set) or \
            store.stats.cold_lookups - lookups0 != cold_ids.size:
        raise AssertionError(f"tier: the sweep made {sweep_launches} decode launches "
                             f"and {store.stats.cold_lookups - lookups0} cold lookups, "
                             f"expected {hot_calls(batches, n_all, cold_set)} and "
                             f"{cold_ids.size}")
    rng = np.random.default_rng(SEED + 6)
    cold_batches = [b for b in np.array_split(rng.permutation(cold_ids),
                                              -(-cold_ids.size // MULTIGET_IDS))]
    hot_batches = [rng.choice(hot_ids, MULTIGET_IDS, replace=False)
                   for _ in cold_batches]
    rates = {}
    for label, id_batches in (("cold", cold_batches), ("hot", hot_batches)):
        before = onpair_decode.decode_compact.launches
        t0 = time.perf_counter()
        answers = [store.multiget(ids) for ids in id_batches]
        rates[label] = sum(map(len, id_batches)) / (time.perf_counter() - t0)
        for ids, got in zip(id_batches, answers):
            check_strings(f"{label}-only multiget", got, [strings[i] for i in ids])
        if onpair_decode.decode_compact.launches - before != (
                len(id_batches) if label == "hot" else 0):
            raise AssertionError(f"tier: {label}-only multigets made "
                                 f"{onpair_decode.decode_compact.launches - before} "
                                 "decode launches")
    del answers
    tier_cold_lookups = store.stats.cold_lookups - lookups0

    # scans: a stream launch per run of hot segments, none for a cold one
    before_dt = onpair_decode.decode_tokens.launches
    t0 = time.perf_counter()
    scanned = []
    for lo in range(0, n_all, spc):
        scanned.extend(store.scan(lo, min(lo + spc, n_all)))
    tier_seg_scan_s = time.perf_counter() - t0
    check_strings("tiered scan, segment-sized ranges", scanned, strings)
    seg_scan_launches = onpair_decode.decode_tokens.launches - before_dt
    before_dt = onpair_decode.decode_tokens.launches
    t0 = time.perf_counter()
    scanned = store.scan(0, n_all)
    tier_scan_all_s = time.perf_counter() - t0
    check_strings("tiered scan(0, n)", scanned, strings)
    del scanned
    scan_all_launches = onpair_decode.decode_tokens.launches - before_dt
    expect_seg_scans = sum(stream_calls(lo, min(lo + spc, n_all), n_all, cold_set)
                           for lo in range(0, n_all, spc))
    if (seg_scan_launches, scan_all_launches) != (
            expect_seg_scans, stream_calls(0, n_all, n_all, cold_set)):
        raise AssertionError(f"tier: {seg_scan_launches} stream launches for the "
                             f"segment-sized scans, {scan_all_launches} for scan(0, n); "
                             f"expected {expect_seg_scans} and "
                             f"{stream_calls(0, n_all, n_all, cold_set)}")

    # a read burst on one cold segment (over the default promote_above)
    # promotes it; tier_op promotes the rest; the mirror is then the one of
    # the opened store, never tiered, byte for byte on the card
    tier.promote_above = 1.0
    burst = np.arange(TIER_COLD[0] * spc, (TIER_COLD[0] + 1) * spc)
    for ids in np.array_split(burst, spc // MULTIGET_IDS):
        check_strings("read-burst multiget", store.multiget(ids),
                      [strings[i] for i in ids])
    tier.promote_above = 1e9
    if sorted(tier.cold) != TIER_COLD[1:] or tier.promotions != 1:
        raise AssertionError(f"tier: the read burst left {sorted(tier.cold)} cold")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    promoted = tier_op(store, "promote")["promoted"]
    torch.cuda.synchronize()
    promote_s = (time.perf_counter() - t0) / max(1, len(promoted))

    def same_mirror(a, b) -> bool:
        (ta, sa), (tb, sb) = a.resident.on_device(), b.resident.on_device()
        return (torch.equal(ta.view(torch.uint8), tb.view(torch.uint8))
                and torch.equal(sa, sb)
                and a.resident_device_bytes == b.resident_device_bytes)

    if promoted != TIER_COLD[1:] or tier.cold or not same_mirror(store, opened) \
            or store.memory_bytes != mem0:
        raise AssertionError("tier: after promoting every segment the mirror or "
                             "memory_bytes differs from a store never tiered")

    # four segments demoted again and saved; the save opened here (served,
    # located in, prefix-scanned) and in a fresh process
    save_reports = [tier.demote(si) for si in TIER_SAVE_COLD]
    if None in save_reports:
        raise AssertionError("tier: a demotion before the save did not happen")
    sdir = os.path.join(tdir, "saved")
    store.save(sdir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiered = CompressedStringStore.open(sdir, device=dev)
    torch.cuda.synchronize()
    tier_open_s = time.perf_counter() - t0
    if sorted(tiered.tier.cold) != TIER_SAVE_COLD:
        raise AssertionError(f"tier: the save opened with {sorted(tiered.tier.cold)} cold")
    tier_served, _, tier_served_scans = serve_all(tiered, strings, "opened tiered store")
    tfresh = fresh_open(sdir, "read", strings, payload_sha, TIER_SAVE_COLD)
    # hits in the cold segments and anywhere, and absent strings (so every
    # segment's index is built and probed)
    loc_q = [strings[i] for i in np.concatenate([
        rng.choice(np.flatnonzero(np.isin(seg_ids, TIER_SAVE_COLD)), 512),
        rng.integers(0, n_all, 504)])] + miss_q[:8]
    t0 = time.perf_counter()
    located = tiered.locate_batch(loc_q)
    tier_locate_s = time.perf_counter() - t0
    if located != [first_id.get(q) for q in loc_q]:
        raise AssertionError("tier: locate on the tiered store missed the lowest id")
    tier_prefix = prefixes[7]
    before_dc = onpair_decode.decode_compact.launches
    t0 = time.perf_counter()
    got = tiered.scan_prefix(tier_prefix, limit=PREFIX_LIMIT)
    tier_prefix_s = time.perf_counter() - t0
    tier_prefix_launches = onpair_decode.decode_compact.launches - before_dc
    want_prefix = sorted((s_, i) for i, s_ in enumerate(strings)
                         if s_.startswith(tier_prefix))[:PREFIX_LIMIT]
    if got != [(i, s_) for s_, i in want_prefix]:
        raise AssertionError(f"tier: scan_prefix({tier_prefix!r}) on the tiered store "
                             "differs from a sorted filter of the source")
    tier_op(store, "promote")
    store.tier = None  # the profiled windows below read it as the earlier phases did
    if not same_mirror(store, opened):
        raise AssertionError("tier: the mirror differs after the second promotion")
    tier_wall = time.perf_counter() - t_phase
    tiered_path = counts.end("tier", ["decode_compact", "decode_tokens", "encode_batch"])
    # launches: the demotions' reads (one each), the scans, the opened
    # store's scan(0, n) and index build (none for a cold segment)
    expect_tier = {
        "decode_compact": sweep_launches + len(hot_batches) + len(burst) // MULTIGET_IDS
        + tier_served + tier_prefix_launches,
        "decode_tokens": len(TIER_COLD) + expect_seg_scans
        + stream_calls(0, n_all, n_all, cold_set) + len(TIER_SAVE_COLD)
        + tier_served_scans + n_seg - len(TIER_SAVE_COLD),
        "encode_batch": encode_calls(loc_q)}
    if tiered_path != expect_tier:
        raise AssertionError(f"tier: launches {tiered_path}, expected {expect_tier}")
    demos = reports + save_reports
    split = {k: np.mean([r[k] for r in demos])
             for k in ("read_s", "factorize_s", "write_s", "adopt_s")}
    rlz_b, pay_b = sum(r["rlz_bytes"] for r in demos), sum(r["payload_bytes"] for r in demos)
    log("tier", f"[{card}] {len(TIER_COLD)} segments demoted off-thread in "
        f"{demote_wall:.3f} s, then {len(TIER_SAVE_COLD)} more; seconds a demotion "
        f"(mean of {len(demos)}): stream read {split['read_s']:.4f}, factorization "
        f"{split['factorize_s']:.3f}, container write {split['write_s']:.4f}, "
        f"adoption with the eviction {split['adopt_s']:.4f}; rlz_bytes {rlz_b} B "
        f"against payload_bytes {pay_b} B ({sum(r['raw_bytes'] for r in demos)} B "
        "raw)")
    log("tier", f"[{card}] with {len(TIER_COLD)} cold: memory_bytes {mem0} -> {mem1}, "
        f"resident_device_bytes {dev0} -> {dev1}, mirror payload {pay0} -> {pay1} B "
        f"(fell by the cold segments' {cold_payload} B)")
    log("tier", f"[{card}] multiget, every id in the read path's {len(batches)} "
        f"shuffled calls: {n_all / mixed_s:.1f} lookups/s ({sweep_launches} decode "
        f"launches, {cold_ids.size} cold lookups); {len(cold_batches)} calls of cold "
        f"ids only {rates['cold']:.1f} lookups/s (0 launches); as many of hot ids only "
        f"{rates['hot']:.1f} lookups/s; cold_lookups {tier_cold_lookups}")
    log("tier", f"[{card}] scan with {len(TIER_COLD)} cold: segment-sized ranges "
        f"{throughput_mib_s(raw_bytes, tier_seg_scan_s):.1f} MiB/s ({seg_scan_launches} "
        f"stream launches); scan(0, n) {throughput_mib_s(raw_bytes, tier_scan_all_s):.1f} "
        f"MiB/s ({scan_all_launches} stream launches, one per hot run)")
    log("tier", f"[{card}] promotion: a read burst promoted segment {TIER_COLD[0]}; "
        f"tier_op promoted {len(promoted)} more at {promote_s:.4f} s each; the mirror "
        "then == the never-tiered opened store's on the card (payload, starts, "
        "device bytes), and memory_bytes as before")
    log("tier", f"[{card}] tiered save (segments {TIER_SAVE_COLD} cold) opened in "
        f"{tier_open_s:.3f} s here, {tfresh['open_s']:.3f} s in a fresh process; every "
        f"id served == the source in both; {len(loc_q)} locates {tier_locate_s:.3f} s "
        f"(index build included), every answer the lowest id; scan_prefix("
        f"{tier_prefix!r}) {tier_prefix_s * 1e3:.1f} ms, {tier_prefix_launches} decode "
        f"launches; the phase's wall {tier_wall:.1f} s")

    # --------------------------------------------------------- 4.7 serving
    # the read store as SERVE_SHARDS shards on one shared device codec (read,
    # scanned, located in, prefix-scanned, tiered, appended to, saved and
    # reopened), then StoreService over the flat read store (point lookups
    # from client threads, bulk multigets) and over a writable store
    # (appends interleaved with reads); every launch recomputed from inputs
    counts.start()
    t_phase = time.perf_counter()
    ddir = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    shard_dir = os.path.join(ddir, "sharded")
    bounds = save_sharded(store, shard_dir, SERVE_SHARDS)
    if bounds != plan_shards(n_all, spc, SERVE_SHARDS):
        raise AssertionError(f"serve: save_sharded wrote bounds {bounds}")
    seg_per_shard = [-(-(hi - lo) // spc) for lo, hi in bounds]
    shard_first_seg = np.cumsum([0] + seg_per_shard[:-1]).tolist()
    shard_lo = np.asarray([lo for lo, _ in bounds], np.int64)
    builds = []
    real_build = ref.DeviceDict.build

    def counting_build(d, device):
        builds.append(device)
        return real_build(d, device)

    ref.DeviceDict.build = staticmethod(counting_build)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = ShardedStringStore.open(shard_dir, device=dev)
        torch.cuda.synchronize()
        shard_open_s = time.perf_counter() - t0
    finally:
        ref.DeviceDict.build = staticmethod(real_build)
    shared = sharded.stores[0]._device
    ptrs = {st._device.dd.mat16.data_ptr() for st in sharded.stores}
    if len(builds) != 1 or any(st._device is not shared for st in sharded.stores) \
            or len(ptrs) != 1:
        raise AssertionError(f"serve: the open ran DeviceDict.build {len(builds)} "
                             f"times and left {len(ptrs)} mat16 tables for "
                             f"{SERVE_SHARDS} shards")
    mirrors = [st.resident.n_bytes for st in sharded.stores]
    if sum(mirrors) != store.resident.n_bytes or \
            [st.segments.n_segments for st in sharded.stores] != seg_per_shard:
        raise AssertionError(f"serve: the shards' mirrors hold {mirrors} B "
                             f"(flat store {store.resident.n_bytes} B), segments "
                             f"{[st.segments.n_segments for st in sharded.stores]}")

    def shard_calls(id_batches, cold_segs=()) -> int:
        """Decode launches of sharded multigets, cache off: one per shard a
        call touches with an id outside the ``cold_segs`` (global segment
        numbers; shards split on segment boundaries)."""
        n = 0
        for ids in map(np.asarray, id_batches):
            hot = ids[~np.isin(ids // spc, list(cold_segs))]
            n += np.unique(np.searchsorted(shard_lo, hot, side="right")).size
        return n

    before = onpair_decode.decode_compact.launches
    t0 = time.perf_counter()
    answers = [sharded.multiget(ids) for ids in batches]
    shard_mg_s = time.perf_counter() - t0
    for ids, got in zip(batches, answers):
        check_strings("sharded multiget", got, [strings[i] for i in ids])
    del answers
    shard_mg_launches = onpair_decode.decode_compact.launches - before
    if shard_mg_launches != shard_calls(batches):
        raise AssertionError(f"serve: {shard_mg_launches} decode launches for the "
                             f"sharded sweep, expected {shard_calls(batches)}")
    before = onpair_decode.decode_tokens.launches
    t0 = time.perf_counter()
    check_strings("sharded scan(0, n)", sharded.scan(0, n_all), strings)
    shard_scan_s = time.perf_counter() - t0
    if onpair_decode.decode_tokens.launches - before != SERVE_SHARDS:
        raise AssertionError(f"serve: sharded scan(0, n) made "
                             f"{onpair_decode.decode_tokens.launches - before} stream "
                             f"launches, expected {SERVE_SHARDS}")
    # the flat store's answers (its indexes built in 4.5), then the shards':
    # the first scan_prefix builds every shard segment's index (one stream
    # launch each) and probes exactly the flat store's strings (the same
    # segments, the same limit each)
    serve_prefix = prefixes[7]
    before = onpair_decode.decode_compact.launches
    flat_prefix = opened.scan_prefix(serve_prefix, limit=PREFIX_LIMIT)
    flat_prefix_launches = onpair_decode.decode_compact.launches - before
    loc_q = hit_q[:MULTIGET_IDS]
    flat_loc = opened.locate_batch(loc_q)
    before = (onpair_decode.decode_compact.launches, onpair_decode.decode_tokens.launches)
    t0 = time.perf_counter()
    shard_prefix = sharded.scan_prefix(serve_prefix, limit=PREFIX_LIMIT)
    shard_prefix_s = time.perf_counter() - t0
    shard_prefix_launches = onpair_decode.decode_compact.launches - before[0]
    index_launches = onpair_decode.decode_tokens.launches - before[1]
    if shard_prefix != flat_prefix or shard_prefix_launches != flat_prefix_launches \
            or index_launches != n_seg:
        raise AssertionError(f"serve: sharded scan_prefix({serve_prefix!r}) made "
                             f"{shard_prefix_launches} decode and {index_launches} "
                             f"stream launches (flat: {flat_prefix_launches} and "
                             f"{n_seg} index builds), answers equal: "
                             f"{shard_prefix == flat_prefix}")
    t0 = time.perf_counter()
    shard_loc = sharded.locate_batch(loc_q)
    shard_loc_s = time.perf_counter() - t0
    if shard_loc != flat_loc or shard_loc != want_hits[:MULTIGET_IDS]:
        raise AssertionError("serve: sharded locate_batch differs from the flat store's")
    # each shard encodes the queries no earlier shard answered
    ans = np.asarray(flat_loc, np.int64)
    shard_loc_encode = sum(encode_calls([q for q, a in zip(loc_q, ans) if a >= lo])
                           for lo in shard_lo if (ans >= lo).any())

    # the tier fan-out: one segment of each shard demoted, every id read back
    # (cold ones from RLZ on the host), every segment promoted
    cold_local = [c % seg_per_shard[k] for k, c in enumerate(SERVE_COLD)]
    cold_global = [shard_first_seg[k] + c for k, c in enumerate(cold_local)]
    t0 = time.perf_counter()
    demoted = [sharded.demote(shard=k, segment=c, promote_above=1e9,
                              workdir=os.path.join(ddir, f"tier-{k}"))[0]
               for k, c in enumerate(cold_local)]
    shard_demote_s = time.perf_counter() - t0
    if [r["demoted"] for r in demoted] != [[c] for c in cold_local]:
        raise AssertionError(f"serve: the fan-out demoted {demoted}")
    if sum(st.resident.n_bytes for st in sharded.stores) != store.resident.n_bytes - sum(
            store.segments.segments[g].payload_bytes for g in cold_global):
        raise AssertionError("serve: the demotions did not take their segments off "
                             "the mirrors")
    before = onpair_decode.decode_compact.launches
    lookups0 = sum(st.stats.cold_lookups for st in sharded.stores)
    t0 = time.perf_counter()
    answers = [sharded.multiget(ids) for ids in batches]
    shard_tier_s = time.perf_counter() - t0
    for ids, got in zip(batches, answers):
        check_strings("sharded multiget with cold segments", got,
                      [strings[i] for i in ids])
    del answers
    shard_cold_lookups = sum(st.stats.cold_lookups for st in sharded.stores) - lookups0
    shard_tier_launches = onpair_decode.decode_compact.launches - before
    n_cold_ids = int(np.isin(np.arange(n_all) // spc, cold_global).sum())
    if (shard_tier_launches, shard_cold_lookups) != (
            shard_calls(batches, cold_global), n_cold_ids):
        raise AssertionError(f"serve: tiered sweep made {shard_tier_launches} decode "
                             f"launches and {shard_cold_lookups} cold lookups, expected "
                             f"{shard_calls(batches, cold_global)} and {n_cold_ids}")
    promoted = sharded.promote()
    if [r["promoted"] for r in promoted] != [[c] for c in cold_local] or \
            sum(st.resident.n_bytes for st in sharded.stores) != store.resident.n_bytes:
        raise AssertionError(f"serve: promote() gave {promoted}")
    tier_rows = sharded.tier_stats()
    del sharded

    # writable: SERVE_EXTEND strings appended to the tail shard, saved,
    # reopened read-only, read back
    ws = ShardedStringStore.open(shard_dir, device=dev, writable=True)
    if len({id(st._device) for st in ws.stores}) != 1:
        raise AssertionError("serve: the writable shards do not share one device codec")
    tail_n0 = ws.stores[-1].n_strings
    app = strings[:SERVE_EXTEND]
    t0 = time.perf_counter()
    app_ids = [i for lo in range(0, SERVE_EXTEND, EXTEND_BATCH)
               for i in ws.extend(app[lo : lo + EXTEND_BATCH])]
    shard_extend_s = time.perf_counter() - t0
    shard_extend_encode = sum(encode_calls(app[lo : lo + EXTEND_BATCH])
                              for lo in range(0, SERVE_EXTEND, EXTEND_BATCH))
    if app_ids != list(range(n_all, n_all + SERVE_EXTEND)) or \
            ws.stores[-1].n_strings != tail_n0 + SERVE_EXTEND or \
            [st.n_strings for st in ws.stores[:-1]] != [hi - lo for lo, hi in bounds[:-1]]:
        raise AssertionError("serve: the appends did not land on the tail shard")
    t0 = time.perf_counter()
    ws.save()
    shard_save_s = time.perf_counter() - t0
    del ws
    # the tail shard's saved generation holds the shared dictionary, byte
    # for byte: the reopen opens it on the shared device codec too
    builds.clear()
    ref.DeviceDict.build = staticmethod(counting_build)
    try:
        re_sharded = ShardedStringStore.open(shard_dir, device=dev)
    finally:
        ref.DeviceDict.build = staticmethod(real_build)
    if len(builds) != 1 or len({id(st._device) for st in re_sharded.stores}) != 1:
        raise AssertionError(f"serve: the reopen after the save of appends ran "
                             f"DeviceDict.build {len(builds)} times")
    if re_sharded.n_strings != n_all + SERVE_EXTEND:
        raise AssertionError(f"serve: the reopened shards hold {re_sharded.n_strings}")
    app_batches = [app_ids[i : i + MULTIGET_IDS]
                   for i in range(0, SERVE_EXTEND, MULTIGET_IDS)]
    for ids in app_batches:
        check_strings("appended ids after save and reopen", re_sharded.multiget(ids),
                      [app[i - n_all] for i in ids])
    del re_sharded
    shutil.rmtree(ddir, ignore_errors=True)

    # StoreService over the flat read store: SERVE_CLIENTS threads of point
    # lookups, then SERVE_MULTIGET_CLIENTS threads of 1,024-id requests that
    # cover every id once (closed loops: a drained batch holds at most a
    # request a client, under ops._DECODE_MAX_ROWS ids, so every read batch
    # is one decode launch), then the same requests as one open-loop burst,
    # whose drained batches of up to max_batch requests split into launches
    # of ops._DECODE_MAX_ROWS ids. Every store.multiget call is logged: its
    # launches follow from its unique ids (cache_bytes=0, no cold segment)
    get_ids = np.random.default_rng(SEED + 8).permutation(n_all)[:SERVE_GET_IDS]
    errors: list = []
    flat_calls: list = []
    burst_gate = threading.Event()
    burst_gate.set()

    def flat_logged_multiget(ids):
        burst_gate.wait(60)  # holds the worker while a burst is queued
        flat_calls.append(np.unique(np.asarray(ids, np.int64)).size)
        return type(store).multiget(store, ids)

    def flat_launches(calls) -> int:
        return sum(-(-n // ops._DECODE_MAX_ROWS) for n in calls)

    def run_clients(target, shares) -> float:
        threads = [threading.Thread(target=target, args=(share,)) for share in shares]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        raise_if_clients_failed("serve: a client thread", threads, errors)
        return wall

    def getter(share):
        try:
            for i in share.tolist():
                if svc.get(i, timeout=60) != strings[i]:
                    raise AssertionError(f"service get({i}) differs from its source")
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    def multigetter(share):
        # a closed loop, each request awaited before the next: a drained
        # batch holds at most one request a thread, under a launch's row cap
        try:
            for ids in share:
                check_strings("service multiget", svc.submit_multiget(ids).result(60),
                              [strings[i] for i in ids])
        except Exception as e:
            errors.append(e)

    before = onpair_decode.decode_compact.launches
    store.multiget = flat_logged_multiget
    try:
        svc = StoreService(store)
        try:
            get_wall = run_clients(getter, [get_ids[k::SERVE_CLIENTS]
                                            for k in range(SERVE_CLIENTS)])
            get_stats = svc.stats()
            mg_wall = run_clients(multigetter, [batches[k::SERVE_MULTIGET_CLIENTS]
                                                for k in range(SERVE_MULTIGET_CLIENTS)])
        finally:
            svc.close()
        closed_stats = svc.stats()  # read after close() joined the worker
        closed_launches = onpair_decode.decode_compact.launches - before
        closed_calls = len(flat_calls)
        workers = [svc._worker]
        burst_gate.clear()
        svc = StoreService(store)
        try:
            t0 = time.perf_counter()
            burst = [svc.submit_multiget(ids) for ids in batches]
            burst_gate.set()
            for ids, fut in zip(batches, burst):
                check_strings("service multiget burst", fut.result(60),
                              [strings[i] for i in ids])
            burst_wall = time.perf_counter() - t0
        finally:
            burst_gate.set()
            svc.close()
        workers.append(svc._worker)
    finally:
        del store.multiget  # the class's again
    if any(w.is_alive() for w in workers):
        raise AssertionError("serve: close() did not join the service's worker")
    burst_stats = svc.stats()
    svc_launches = onpair_decode.decode_compact.launches - before
    burst_calls = flat_calls[closed_calls:]
    if closed_launches != closed_stats["batches"] or \
            closed_launches != flat_launches(flat_calls[:closed_calls]) or \
            closed_calls != closed_stats["batches"] or \
            closed_stats["requests"] != get_ids.size + n_all or \
            svc_launches - closed_launches != flat_launches(burst_calls) or \
            len(burst_calls) != burst_stats["batches"] or \
            burst_stats["requests"] != n_all:
        raise AssertionError(f"serve: the service made {closed_launches} decode launches "
                             f"for {closed_stats['batches']} batches of closed loops "
                             f"and {svc_launches - closed_launches} for "
                             f"{burst_stats['batches']} batches of a burst, in "
                             f"{len(flat_calls)} store calls")
    if max(burst_calls) <= ops._DECODE_MAX_ROWS:
        raise AssertionError(f"serve: no batch of the open-loop burst split (largest "
                             f"{max(burst_calls)} ids)")

    # StoreService over a writable store: appends interleaved with reads of
    # old ids and of acknowledged new ones; seals inline, so each logged
    # store call's launches follow from its ids and the sealed count
    mstore = MutableStringStore(dictionary, corpus, device=dev, config=config,
                                strings_per_segment=spc, cache_bytes=0,
                                async_seal=False)
    store_calls: list = []
    real_multiget, real_extend = mstore.multiget, mstore.extend

    def logged_multiget(ids):
        store_calls.append(("multiget", np.asarray(ids, np.int64), mstore.n_sealed))
        return real_multiget(ids)

    def logged_extend(batch):
        store_calls.append(("extend", list(batch)))
        return real_extend(batch)

    mstore.multiget, mstore.extend = logged_multiget, logged_extend
    rng = np.random.default_rng(SEED + 9)
    append_futs, read_futs = [], []
    msvc = StoreService(mstore)
    try:
        t0 = time.perf_counter()
        for j, s in enumerate(app):
            append_futs.append(msvc.submit_append(s))
            if j % 50 == 49:
                # appends resolve in order: every id up to this one is acked
                acked = append_futs[j - 49].result(60)
                ids = np.concatenate([rng.integers(0, n_all, 48),
                                      rng.integers(n_all, acked + 1, 16)])
                read_futs.append((ids, msvc.submit_multiget(ids)))
        new_ids = [f.result(60) for f in append_futs]
        for ids, fut in read_futs:
            got = fut.result(60)
            check_strings("service read between appends", got,
                          [strings[i] if i < n_all else app[i - n_all] for i in ids])
        mixed_wall = time.perf_counter() - t0
    finally:
        msvc.close()
    m_stats = msvc.stats()
    n_extends = sum(kind == "extend" for kind, *_ in store_calls)
    if new_ids != list(range(n_all, n_all + SERVE_EXTEND)) or \
            m_stats["append_batches"] != n_extends or m_stats["appends"] != SERVE_EXTEND:
        raise AssertionError(f"serve: appends through the service gave ids "
                             f"{new_ids[:3]}..., {m_stats['append_batches']} append "
                             f"batches for {n_extends} extend calls")
    for ids in app_batches:
        check_strings("appended ids", mstore.multiget(ids), [app[i - n_all] for i in ids])
    serve_tail_calls = sum(bool((c[1] >= c[2]).any()) for c in store_calls
                           if c[0] == "multiget")
    mutable_decode = sum(bool((c[1] < c[2]).any()) for c in store_calls
                         if c[0] == "multiget") + serve_tail_calls
    mutable_encode = sum(encode_calls(c[1]) for c in store_calls if c[0] == "extend")
    del mstore, store_calls
    serve_prefix_launches = 2 * flat_prefix_launches  # the flat store's and the shards'
    serve_wall = time.perf_counter() - t_phase
    serve = counts.end("serve", ["decode_compact", "decode_tokens", "encode_batch"])
    expect_serve = {
        "decode_compact": shard_mg_launches + serve_prefix_launches
        + shard_tier_launches + len(app_batches) + svc_launches + mutable_decode,
        # the shards' whole ranges, their index builds, the demotions' reads
        "decode_tokens": SERVE_SHARDS + n_seg + SERVE_SHARDS,
        "encode_batch": encode_calls(loc_q) + shard_loc_encode + shard_extend_encode
        + mutable_encode}
    if serve != expect_serve:
        raise AssertionError(f"serve: launches {serve}, expected {expect_serve}")
    get_lat, closed_lat = get_stats["request_latency"], closed_stats["request_latency"]
    log("serve", f"[{card}] {SERVE_SHARDS} shards of {seg_per_shard} segments (bounds "
        f"{bounds}) opened in {shard_open_s:.3f} s with one OnPairDevice (DeviceDict."
        f"build ran once; one mat16 table); mirrors {mirrors} B, together the flat "
        f"store's {store.resident.n_bytes} B")
    log("serve", f"[{card}] sharded multiget, every id in the read path's "
        f"{len(batches)} shuffled calls: {n_all / shard_mg_s:.1f} lookups/s "
        f"({shard_mg_launches} decode launches, one per shard a call touches), "
        f"against the flat store's {n_all / multiget_s:.1f} in 4.1; scan(0, n) "
        f"{throughput_mib_s(raw_bytes, shard_scan_s):.1f} MiB/s ({SERVE_SHARDS} stream "
        f"launches); scan_prefix({serve_prefix!r}) {shard_prefix_s:.3f} s with the "
        f"{n_seg} index builds, {shard_prefix_launches} probes (== the flat store's); "
        f"locate_batch of {len(loc_q)} hits {shard_loc_s:.3f} s (== the flat store's)")
    log("serve", f"[{card}] tier fan-out: segments {cold_local} (global {cold_global}) "
        f"demoted, one a shard, in {shard_demote_s:.3f} s; every id read back at "
        f"{n_all / shard_tier_s:.1f} lookups/s ({shard_tier_launches} decode launches, "
        f"{shard_cold_lookups} cold lookups); promote() brought every mirror back; "
        f"tier_stats n_cold {[r['n_cold'] for r in tier_rows]}")
    log("serve", f"[{card}] writable shards: {SERVE_EXTEND} strings extended onto the "
        f"tail shard in {shard_extend_s:.3f} s ({shard_extend_encode} encode launches), "
        f"save() {shard_save_s:.3f} s, reopened on one OnPairDevice (DeviceDict.build "
        "ran once) and read back == the source")
    log("serve", f"[{card}] StoreService over the flat store: {get_ids.size} get() "
        f"from {SERVE_CLIENTS} threads {get_ids.size / get_wall:.1f} requests/s "
        f"(avg_batch {get_stats['avg_batch']}, max_batch_seen "
        f"{get_stats['max_batch_seen']}, latency p50 {get_lat['p50_us']:.1f} us, p99 "
        f"{get_lat['p99_us']:.1f} us); {len(batches)} submit_multiget of "
        f"{MULTIGET_IDS} ids from {SERVE_MULTIGET_CLIENTS} threads "
        f"{n_all / mg_wall:.1f} lookups/s; {closed_stats['requests']} requests in "
        f"closed loops in {closed_stats['batches']} batches == {closed_launches} decode "
        f"launches (avg_batch {closed_stats['avg_batch']}, max_batch_seen "
        f"{closed_stats['max_batch_seen']}, p50 {closed_lat['p50_us']:.1f} us, p99 "
        f"{closed_lat['p99_us']:.1f} us); the same {len(batches)} requests as one "
        f"open-loop burst {n_all / burst_wall:.1f} lookups/s in {burst_stats['batches']} "
        f"batches of up to {max(burst_calls)} ids, {svc_launches - closed_launches} decode "
        f"launches == sum of ceil(ids / {ops._DECODE_MAX_ROWS}) over the store calls")
    log("serve", f"[{card}] StoreService over a writable store: {SERVE_EXTEND} "
        f"submit_append with {len(read_futs)} reads between them in {mixed_wall:.3f} s; "
        f"ids contiguous and in order; {m_stats['append_batches']} append batches == "
        f"{n_extends} extend calls; every id == its source; the phase's wall "
        f"{serve_wall:.1f} s")

    # ------------------------------------------------------------ 4.8 codecs
    codecs_phase(card, dev, strings, store.artifact, corpus, counts, encode_calls,
                 fresh_open)


    # ------------------------------------------- 5. device share of each path
    # a window of each path, driven as above but under torch.profiler (after
    # the counts were read): kernel device time over the window's wall
    encoder = Encoder(dictionary, device=dev)
    tiered_cold_ids = np.random.default_rng(SEED + 7).permutation(
        np.flatnonzero(np.isin(seg_ids, TIER_SAVE_COLD)))
    tiered_cold_batches = np.array_split(
        tiered_cold_ids, -(-tiered_cold_ids.size // MULTIGET_IDS))
    wwin = MutableStringStore(dictionary, corpus, device=dev, config=config,
                              strings_per_segment=STRINGS_PER_SEGMENT,
                              cache_bytes=0)

    def extend_window():
        for lo in range(0, ENCODE_WINDOW, EXTEND_BATCH):
            wwin.extend(strings[lo : lo + EXTEND_BATCH])
        wwin.seal_barrier()

    # Every window's kernel records must number the wrappers' launches in
    # it. At times the profiler loses the records of a window's first
    # launches (their copies too): a short window is logged with where the
    # records it kept lie, and run again (``checked``)
    window_runs: dict[str, int] = {}

    def window(path, fn):
        got, window_runs[path] = checked(f"the {path} window",
                                         lambda: device_window(fn), counts.kernels)
        return got

    windows = {
        "encode": window("encode", lambda: encoder.encode(strings)),
        "multiget": window(
            "multiget", lambda: [store.multiget(ids) for ids in batches[:MULTIGET_WINDOW]]),
        "decode_all": window("decode_all", lambda: decoder.decode_all(corpus)),
        "scan": window("scan", lambda: store.scan(0, n_all)),
        "extend": window("extend", extend_window),
        "compact": window("compact", wwin.compact),
        "locate": window(
            "locate", lambda: [opened.locate_batch(hit_q[i : i + MULTIGET_IDS])
                               for i in range(0, 10 * MULTIGET_IDS, MULTIGET_IDS)]),
        "scan_prefix": window(
            "scan_prefix", lambda: opened.scan_prefix(prefixes[7], limit=PREFIX_LIMIT)),
        "cold multiget": window(
            "cold multiget", lambda: [tiered.multiget(ids) for ids in tiered_cold_batches]),
    }
    # the service's window: the same 1,024-id calls as submit_multiget, each
    # answered by the worker thread's launch; the profiler must see them all
    wsvc = StoreService(store)
    wsvc.submit_multiget(batches[0]).result(60)  # the worker's first launch, unprofiled
    batches0 = wsvc.batches
    before = onpair_decode.decode_compact.launches
    try:
        windows["service multiget"] = window(
            "service multiget", lambda: [wsvc.submit_multiget(ids).result(60)
                                         for ids in batches[:MULTIGET_WINDOW]])
    finally:
        wsvc.close()
    svc_seen = windows["service multiget"][1].get("decode_compact", [0])[0]
    if svc_seen != MULTIGET_WINDOW or \
            onpair_decode.decode_compact.launches - before != wsvc.batches - batches0:
        raise AssertionError(f"serve: torch.profiler saw {svc_seen} decode_rows_kernel "
                             f"launches in the last service window; "
                             f"{onpair_decode.decode_compact.launches - before} launches "
                             f"for {wsvc.batches - batches0} batches")
    log("device", f"[{card}] every window's kernel records == the wrappers' launches; "
        f"runs each window took: {window_runs}")
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
    busy = {p: sum(sec for _, sec in windows[p][1].values()) / windows[p][0]
            for p in ("multiget", "service multiget")}
    log("device", f"[{card}] {MULTIGET_WINDOW} calls of {MULTIGET_IDS} ids: device busy "
        f"{busy['multiget']:.2%} through store.multiget ({windows['multiget'][0]:.3f} "
        f"s), {busy['service multiget']:.2%} through StoreService.submit_multiget "
        f"({windows['service multiget'][0]:.3f} s; {svc_seen} decode_rows_kernel "
        "launches from the worker thread, all seen by torch.profiler)")

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
    log("host", f"[{card}] 10 locate_batch calls of {MULTIGET_IDS} hits on the opened "
        "store under cProfile: " + host_profile(
            lambda: [opened.locate_batch(hit_q[i : i + MULTIGET_IDS])
                     for i in range(0, 10 * MULTIGET_IDS, MULTIGET_IDS)], top=12))
    log("host", f"[{card}] scan_prefix({prefixes[7]!r}, limit={PREFIX_LIMIT}) on the "
        "opened store under cProfile: " + host_profile(
            lambda: opened.scan_prefix(prefixes[7], limit=PREFIX_LIMIT), top=12))
    log("host", f"[{card}] {len(tiered_cold_batches)} multiget calls of cold ids only "
        f"(segments {TIER_SAVE_COLD} of the opened tiered store) under cProfile: "
        + host_profile(lambda: [tiered.multiget(ids) for ids in tiered_cold_batches],
                       top=12))
    del opened, tiered
    shutil.rmtree(tdir, ignore_errors=True)
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
        # and in the codecs phase's encode of the corpus
        enc_inputs.setdefault(f"({sel.size}, {cap}+16)",
                              (D, L, 3 * enc_shapes[(sel.size, cap)]))
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
        counts.total["decode_compact"] - tail_launches - w_tail_calls - prefix_launches
        - tier_prefix_launches - serve_prefix_launches - serve_tail_calls)
    # a scan_prefix probe decodes one string of the mirror a launch
    ids = np.asarray(order[:1])
    rows_inputs["a 1-id scan_prefix probe from the mirror (uint16)"] = (
        rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
                  "a scan_prefix probe's one row"),
        rows_bytes(row_tokens(ids), 1, True, int(mirror_off(ids)[-1])),
        prefix_launches + tier_prefix_launches + serve_prefix_launches)
    ids = order[: ops._DECODE_MAX_ROWS]
    rows_pair(res_tokens, res_starts, ids, mirror_off(ids),
              f"a full launch of {ids.size} mirror rows")
    tail_u = list(dict.fromkeys(tail_ids))
    tk, st, off = host_rows([row_tokens([i]) for i in tail_u])
    # (the persist phase's multigets and the serve phase's writable service
    # send a few tail rows a call: counted here)
    rows_inputs[f"{len(tail_u)} tail rows from the host (int32)"] = (
        rows_pair(tk, st, None, off, "the writable phase's tail rows"),
        rows_bytes(row_tokens(tail_u), len(tail_u), False, int(off[-1])),
        tail_launches + w_tail_calls + serve_tail_calls)
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
        fn()  # warm-up, outside the profiled calls
        (device, acts), runs = checked(
            f"{name} {shape} timing", lambda: device_ms(fn, name, 200), counts.kernels)
        window_runs[f"{name} {shape}"] = runs
        call = cuda_ms(fn, 200)
        if device is None:
            log("numbers", f"torch.profiler saw no device time for {name}; its "
                "time below is the per-call time from CUDA events")
        seen = {k: n for k, (n, _) in sorted(acts.items())}
        log("numbers", f"{name} {shape}: device activity over 200 calls under "
            f"torch.profiler: {seen}")
        # one launch of the kernel a wrapper call, and no memset for the stream
        if seen.get(name) != 200 or (name == "decode_tokens" and "sets" in seen):
            raise AssertionError(f"{name} {shape}: not one kernel launch a call, "
                                 f"or a memset: {seen}")
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
    # scan(0, n), the scan after compact() and the opened store's scan(0, n)
    # each read the whole mirror; every other stream launch reads a range of
    # at most a segment's strings (but the persist phase's writable store's
    # three scans of its whole, a third of the corpus, and the serve phase's
    # scan of each shard's whole, a quarter, counted here too)
    whole_launches = 3
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
    log("numbers", f"runs each profiled window and timing took, every one's kernel "
        f"records == the wrappers' launches: {window_runs}")
    for r in per_shape:
        log("numbers", f"[{card}] {r['name']} {r['shape']}: {r['ms'] * 1e3:.2f} us "
            f"device time per call ({r['method']}), {r['call_ms'] * 1e3:.2f} us "
            f"per wrapper call (CUDA events over 200 calls), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bytes']} B at 3.35 TB/s); {r['launches']} launches on the "
            "paths (L2 warm)")
    # ------------------------------------------------------------- 7. wire
    # last: a profiled window right after the wire's (whose launches come
    # from the servers' threads) once lost records three runs in a row
    # (PERF.md §7), so no window or timing follows it
    cheap = sorted(range(PREFIXES), key=lambda k: prefix_calls[k][0])[:WIRE_PREFIXES]
    wire_phase(card, dev, strings, store, batches, n_all / shard_mg_s, counts,
               encode_calls, hit_q, want_hits, miss_q,
               [(prefixes[k], expected[prefixes[k]][:PREFIX_LIMIT], prefix_calls[k][0])
                for k in cheap])
    # ----------------------------------------------------------- 8. clients
    # after the wire, with no profiled window: the client over every
    # frontend, a cluster of child processes and the load harness
    client_phase(card, dev, strings, store, batches, counts)
    # --------------------------------------------------------------- 9. LM
    # the launcher's LM role: prompts fetched through the decode kernel from
    # a store built on the encode kernel, prefill and decode on the card
    lm = lm_phase(card, dev, counts)
    # -------------------------------------------------------------- 10. train
    # the training launcher: the smoke configs' steps card against host,
    # resume and preemption in child processes, mamba2-780m at full width
    # the dist phase's six tensor-parallel ranks start here, beside the
    # train phase's own children; its timed full-width run waits for them
    ranks = start_tp_ranks(dev, lm["fp32_card"])
    trained = train_phase(card, dev, counts, lm.pop("host"), dry, ranks["procs"])
    # --------------------------------------------------------------- 11. dist
    # the distributed layer: a one-rank NCCL group, compressed_pmean over the
    # full-width gradients, train_lm --mesh 1,1, a checkpoint on the mesh,
    # and the tensor-parallel ranks of a (1, 2) and a (2, 2) mesh on gloo
    dist_phase(card, dev, counts, trained, lm["fp32_card"], ranks)
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
        # (the per-shape rows cover the paths before the wire phase; its
        # launches, at the rows' shapes, count in ``launches`` below)

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
    log("timing", "seconds from the start at which each phase first logged: "
        + ", ".join(f"{k} {v:.1f}" for k, v in FIRST_LOG.items())
        + f"; the end {time.perf_counter() - T_START:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def codecs_phase(card: str, dev: torch.device, strings: list[bytes], artifact,
                 corpus, counts: PathCounts, encode_calls, fresh_open) -> None:
    """The codec registry and every codec of the paper's Table 3, through
    the entry points a user calls: the host batch parse held against the
    encode kernel over the whole corpus, each codec trained and round-tripped
    at ``CODEC_DATA_BYTES`` on the host, stores of the host codecs (no kernel
    launch, ``backend == "numpy"``), a writable store of unbounded OnPair
    compacted and opened in a fresh process, and an OnPair16 store built by
    codec name on the card with its launches recomputed."""
    from repro_torch.core import Encoder, registry
    from repro_torch.data.synth import load_dataset
    from repro_torch.store import CompressedStringStore, MutableStringStore

    counts.start()
    t_phase = time.perf_counter()
    # ----- the registry: OnPair16 alone runs on the kernels
    for name in registry.names(include_unavailable=True):
        spec = registry.get_spec(name)
        log("codecs", f"{name}: {spec.caps}, aliases {spec.aliases}, available "
            f"{spec.available} {spec.unavailable_reason}".rstrip())
    decodable = [n for n in registry.names(include_unavailable=True)
                 if registry.capabilities(n).device_decodable]
    if decodable != ["onpair16"]:
        raise AssertionError(f"codecs: device_decodable codecs {decodable}")

    # ----- the host parse against the encode kernel, the whole corpus, the
    # read phase's artifact (no retraining)
    host16 = registry.codec_from_artifact(artifact)
    t0 = time.perf_counter()
    host_corpus = host16.compress(strings)
    host_s = time.perf_counter() - t0
    encoder = Encoder(artifact, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel_corpus = encoder.encode(strings)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    for name, other in (("the encode kernel's", kernel_corpus),
                        ("the read phase's", corpus)):
        if host_corpus.payload.tobytes() != other.payload.tobytes() or \
                not np.array_equal(host_corpus.offsets, other.offsets):
            raise AssertionError(f"codecs: the host parse_batch differs from "
                                 f"{name} payload or offsets")
    expect_encode = encode_calls(strings)
    raw_all = sum(map(len, strings))
    log("codecs", f"[{card}] host parse_batch == the encode kernel, payload and "
        f"offsets byte for byte, over {len(strings)} strings: host {host_s:.3f} s "
        f"({raw_all / host_s / (1 << 20):.3f} MiB/s), Encoder on the card "
        f"{kernel_s:.3f} s ({raw_all / kernel_s / (1 << 20):.3f} MiB/s, "
        f"{expect_encode} launches)")
    del host_corpus, kernel_corpus

    # ----- every codec on the smaller corpus, on the host
    small = load_dataset("book_titles", CODEC_DATA_BYTES, seed=SEED)
    joined = b"".join(small)
    log("codecs", f"book_titles at {CODEC_DATA_BYTES} B, seed {SEED}: {len(small)} "
        f"strings, {len(joined)} B, sha256 {hashlib.sha256(joined).hexdigest()[:16]} "
        f"(numpy {np.__version__})")
    access_ids = np.random.default_rng(SEED + 10).integers(0, len(small), CODEC_ACCESS)
    ratios, made = {}, {}
    for name in registry.names():
        kw = {"sample_bytes": CODEC_SAMPLES[name]} if name in CODEC_SAMPLES else {}
        codec = registry.create(name, **kw)
        t0 = time.perf_counter()
        codec.train(small, len(joined))
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        comp = codec.compress(small)
        compress_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = codec.decompress_all(comp)
        decompress_s = time.perf_counter() - t0
        if whole != joined:
            raise AssertionError(f"codecs: {name} decompress_all differs from the source")
        t0 = time.perf_counter()
        got = [codec.access(comp, int(i)) for i in access_ids]
        access_s = time.perf_counter() - t0
        check_strings(f"{name} access", got, [small[i] for i in access_ids])
        ratios[name] = comp.ratio
        made[name] = (codec, comp)
        log("codecs", f"[{card}] {name} ({kw or 'defaults'}): ratio {comp.ratio:.4f}; "
            f"train {train_s:.3f} s, compress {compress_s:.3f} s "
            f"({len(joined) / compress_s / (1 << 20):.3f} MiB/s), decompress_all "
            f"{decompress_s:.3f} s, {CODEC_ACCESS} access {access_s / CODEC_ACCESS * 1e6:.1f} "
            f"us each; == the source")
    if not (ratios["onpair"] >= 0.98 * ratios["onpair16"]
            and ratios["onpair16"] > 1.1 * ratios["fsst"]):
        raise AssertionError(f"codecs: the paper's ratio order fails: {ratios}")

    # ----- stores of the host codecs: no kernel launch, backend "numpy"
    def launched():
        return {k: w.launches for k, w in counts.kernels.items()}

    before = launched()
    host_stores = {}
    for name in ("onpair", "bpe"):
        t0 = time.perf_counter()
        st = CompressedStringStore.build(small, codec=name,
                                         sample_bytes=CODEC_SAMPLES[name],
                                         cache_bytes=0,
                                         strings_per_segment=STRINGS_PER_SEGMENT)
        build_s = time.perf_counter() - t0
        if st.backend != "numpy" or st.stats_snapshot()["backend"] != "numpy" or \
                st._device is not None or st.resident is not None:
            raise AssertionError(f"codecs: the {name} store is not on the host path")
        if st.corpus.payload.tobytes() != made[name][1].payload.tobytes():
            raise AssertionError(f"codecs: build(codec={name!r}) compressed other "
                                 "bytes than the codec")
        perm = np.random.default_rng(SEED).permutation(len(small))
        calls = [perm[i : i + MULTIGET_IDS] for i in range(0, len(small), MULTIGET_IDS)]
        t0 = time.perf_counter()
        answers = [st.multiget(ids) for ids in calls]
        mg_s = time.perf_counter() - t0
        for ids, got in zip(calls, answers):
            check_strings(f"{name} store multiget", got, [small[i] for i in ids])
        t0 = time.perf_counter()
        check_strings(f"{name} store scan(0, n)", st.scan(0, len(small)), small)
        scan_s = time.perf_counter() - t0
        host_stores[name] = st
        log("codecs", f"[{card}] CompressedStringStore.build(codec={name!r}) "
            f"{build_s:.3f} s, backend {st.backend}; multiget of every id in "
            f"{len(calls)} shuffled calls {len(small) / mg_s:.1f} lookups/s; scan(0, n) "
            f"{len(joined) / scan_s / (1 << 20):.1f} MiB/s; == the source")
    for name, bad in (("bpe", "cuda"), ("bpe", "cpu")):
        try:
            CompressedStringStore.build(small[:100], codec=name, device=bad)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError(f"codecs: build(codec={name!r}, device={bad!r}) ran")
    log("codecs", f"build(codec='bpe', device='cuda' or 'cpu') raises ValueError: {refusal}")
    for name in ("fsst", "lz-block", "raw"):
        codec, comp = made[name]
        try:
            CompressedStringStore(codec.to_artifact(), comp)
        except ValueError as e:
            if "token-stream codec" not in str(e):
                raise
            log("codecs", f"a {name} store is refused: {e}")
        else:
            raise AssertionError(f"codecs: a store of {name} opened")

    # ----- a writable store of unbounded OnPair: appends, a seal, compact(),
    # every string back, saved and opened in a fresh process
    t0 = time.perf_counter()
    onpair = host_stores["onpair"]
    w = MutableStringStore(onpair.artifact, onpair.corpus, cache_bytes=0,
                           strings_per_segment=STRINGS_PER_SEGMENT)
    extra = strings[-CODEC_APPENDS:]
    for lo in range(0, CODEC_APPENDS, EXTEND_BATCH):
        w.extend(extra[lo : lo + EXTEND_BATCH])
    w.seal()
    report = w.compact()
    want = small + extra
    perm = np.random.default_rng(SEED + 11).permutation(len(want))
    for i in range(0, len(want), MULTIGET_IDS):
        ids = perm[i : i + MULTIGET_IDS]
        check_strings("unbounded OnPair writable multiget", w.multiget(ids),
                      [want[j] for j in ids])
    check_strings("unbounded OnPair writable scan(0, n)", w.scan(0, len(want)), want)
    if launched() != before:
        raise AssertionError(f"codecs: the host-codec stores launched kernels: "
                             f"{before} -> {launched()}")
    wdir = tempfile.mkdtemp(prefix="chip-smoke-codecs-")
    try:
        w.save(wdir)
        probe = fresh_open(wdir, "writable", want, hashlib.sha256(
            w.snapshot_corpus().payload).hexdigest()[:16])
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    log("codecs", f"[{card}] writable unbounded OnPair store: {CODEC_APPENDS} appended "
        f"in batches of {EXTEND_BATCH}, sealed, compact() {report}; every string back "
        f"== the source; no kernel launched by the host stores; saved and opened in "
        f"a fresh process in {probe['open_s']:.3f} s, every string back; "
        f"{time.perf_counter() - t0:.1f} s in all")
    del host_stores, onpair, w

    # ----- OnPair16 built by codec name on the card: launches recomputed
    before = launched()
    st16 = CompressedStringStore.build(small, codec="onpair16",
                                       sample_bytes=CODEC_SAMPLES["onpair16"],
                                       device=dev, cache_bytes=0,
                                       strings_per_segment=STRINGS_PER_SEGMENT)
    if st16.backend != dev.type:  # "cuda": the card's
        raise AssertionError(f"codecs: build(codec='onpair16') serves on {st16.backend}")
    if st16.corpus.payload.tobytes() != made["onpair16"][1].payload.tobytes():
        raise AssertionError("codecs: build(codec='onpair16') encoded other bytes "
                             "than the host codec")
    calls = [list(range(i, min(i + MULTIGET_IDS, len(small))))
             for i in range(0, len(small), MULTIGET_IDS)]
    for ids in calls:
        check_strings("onpair16 store multiget", st16.multiget(ids[::-1]),
                      [small[i] for i in ids[::-1]])
    check_strings("onpair16 store scan(0, n)", st16.scan(0, len(small)), small)
    got = {k: n - before[k] for k, n in launched().items()}
    want16 = {"decode_compact": len(calls), "encode_batch": encode_calls(small),
              "decode_tokens": 1}
    if got != want16:
        raise AssertionError(f"codecs: build(codec='onpair16') made {got}, "
                             f"expected {want16}")
    phase = counts.end("codecs", ["decode_compact", "encode_batch", "decode_tokens"])
    expect = dict(want16, encode_batch=want16["encode_batch"] + expect_encode)
    if phase != expect:
        raise AssertionError(f"codecs: launches {phase}, expected {expect}")
    log("codecs", f"[{card}] build(codec='onpair16') on the card: backend "
        f"{st16.backend}, corpus == the host codec's; launches {got} == recomputed; the phase's "
        f"launches {phase}; the phase's wall {time.perf_counter() - t_phase:.1f} s")


def wire_phase(card: str, dev: torch.device, strings: list[bytes], store, batches,
               sharded_rate: float, counts: PathCounts, encode_calls, hit_q,
               want_hits, miss_q, prefix_cases) -> None:
    """The wire: the read store's shards served by ``repro_torch.net``
    ``ShardServer``s in this process on ``dev`` and read through a
    ``DistributedStringStore`` over loopback, every answer checked and
    every launch recomputed from the requests; then one shard served by a
    child process (``python -m repro_torch.net``), scraped, killed,
    restarted on its port and read again. ``prefix_cases`` holds (prefix,
    the flat store's answer, its decode launches)."""
    from repro_torch.core.metrics import throughput_mib_s
    from repro_torch.distributed import save_sharded
    from repro_torch.kernels import onpair_decode, onpair_encode
    from repro_torch.net import DistributedStringStore, ShardServer
    from repro_torch.obs import (fetch_metrics, fetch_traces, find_series,
                                 hist_state_from_rows, parse_prometheus)
    from repro_torch.obs.scrape import fetch_text

    counts.start()
    t_phase = time.perf_counter()
    n_all = len(strings)
    raw_bytes = sum(map(len, strings))
    dc, et, dt = (onpair_decode.decode_compact, onpair_encode.encode_batch,
                  onpair_decode.decode_tokens)
    wdir = tempfile.mkdtemp(prefix="chip-smoke-wire-")
    shard_dir = os.path.join(wdir, "sharded")
    bounds = save_sharded(store, shard_dir, SERVE_SHARDS)
    shard_lo = np.asarray([lo for lo, _ in bounds], np.int64)
    servers: list = []
    routers: list = []
    children: list = []
    errors: list = []
    child_err = open(os.path.join(wdir, "child.stderr"), "w")

    def start_child(port: int):
        """``python -m repro_torch.net`` over shard 0 on ``dev``; returns
        (process, its stdout lines, start time)."""
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.net",
             os.path.join(shard_dir, "shard-0000"), "--port", str(port),
             "--metrics-port", "0", "--device", dev.type],
            stdout=subprocess.PIPE, stderr=child_err, text=True,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        children.append(proc)
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: lines.put((proc.stdout.readline(),
                                                   time.perf_counter())),
                         daemon=True).start()
        return proc, lines, time.perf_counter()

    def await_child(child) -> tuple:
        """(process, port, metrics port, seconds from start to readiness)."""
        proc, lines, t0 = child
        try:
            line, t_ready = lines.get(timeout=WIRE_READY_S)
        except queue.Empty:
            line, t_ready = "", t0
        m = re.search(r"SHARD_SERVER_READY port=(\d+) n_strings=(\d+) writable=1 "
                      r"metrics_port=(\d+) ", line)
        if not m or int(m.group(2)) != bounds[0][1] - bounds[0][0]:
            child_err.flush()
            with open(child_err.name) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"wire: the child server gave no readiness line "
                                 f"within {WIRE_READY_S} s: {line!r}\n{tail}")
        return proc, int(m.group(1)), int(m.group(3)), t_ready - t0

    def shard_calls(id_batches) -> int:
        """Decode launches of routed multigets, cache off and no tail: one
        per shard a call touches."""
        return sum(np.unique(np.searchsorted(shard_lo, np.asarray(ids),
                                             side="right")).size
                   for ids in id_batches)

    def run_threads(target, shares) -> float:
        threads = [threading.Thread(target=target, args=(share,)) for share in shares]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        raise_if_clients_failed("wire: a client thread", threads, errors)
        return wall

    try:
        # the child starts first: its start-up overlaps the in-process work
        child = start_child(0)
        t0 = time.perf_counter()
        servers = [ShardServer.from_dir(os.path.join(shard_dir, f"shard-{k:04d}"),
                                        device=dev, cache_bytes=0).start()
                   for k in range(SERVE_SHARDS)]
        open_s = time.perf_counter() - t0
        dist = DistributedStringStore.connect([s.address for s in servers],
                                              dir_path=shard_dir)
        routers.append(dist)
        if dist.bounds != bounds or not all(s.stats()["writable"] for s in servers):
            raise AssertionError(f"wire: the router holds bounds {dist.bounds}, the "
                                 f"shards {bounds}")

        def svc_batches() -> int:
            return sum(s.service.batches for s in servers)

        # every id, in the read path's shuffled 1,024-id calls, in one
        # profiled window: the servers' service workers launch, and the
        # profiler must see every launch (a short window runs again)
        lat: list = []
        answers: list = []

        def sweep():
            lat.clear()
            answers.clear()
            for ids in batches:
                t1 = time.perf_counter()
                answers.append(dist.multiget(ids))
                lat.append(time.perf_counter() - t1)

        b0, l0 = svc_batches(), dc.launches
        (mg_s, acts), win_runs = checked("the wire multiget window",
                                         lambda: device_window(sweep), counts.kernels)
        for ids, got in zip(batches, answers):
            check_strings("wire multiget", got, [strings[i] for i in ids])
        answers.clear()
        mg_expect = shard_calls(batches)
        if (dc.launches - l0, svc_batches() - b0) != (win_runs * mg_expect,) * 2:
            raise AssertionError(f"wire: {win_runs} sweeps made {dc.launches - l0} "
                                 f"decode launches in {svc_batches() - b0} service "
                                 f"batches, expected {mg_expect} a sweep (a call per "
                                 "shard touched)")
        mg_p50, mg_p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
        busy = (f"{sum(sec for _, sec in acts.values()) / mg_s:.2%}" if acts
                else "not measured (the profiler recorded no device time)")

        # get() from client threads: each server's service coalesces them
        get_ids = np.random.default_rng(SEED + 10).permutation(n_all)[:WIRE_GET_IDS]
        get_lat: list = []

        def getter(share):
            mine = []
            try:
                for i in share.tolist():
                    t1 = time.perf_counter()
                    got = dist.get(i)
                    mine.append(time.perf_counter() - t1)
                    if got != strings[i]:
                        raise AssertionError(f"wire get({i}) differs from its source")
            except Exception as e:  # re-raised on the main thread
                errors.append(e)
            get_lat.extend(mine)

        b0, l0 = svc_batches(), dc.launches
        get_wall = run_threads(getter, [get_ids[k::SERVE_CLIENTS]
                                        for k in range(SERVE_CLIENTS)])
        get_batches, get_launches = svc_batches() - b0, dc.launches - l0
        if get_launches != get_batches or len(get_lat) != get_ids.size:
            raise AssertionError(f"wire: get() made {get_launches} decode launches "
                                 f"in {get_batches} service batches")
        get_p50, get_p99 = np.percentile(np.asarray(get_lat) * 1e6, [50, 99])

        # scan(0, n) in scan_chunk RPCs while a second connection reads
        second = DistributedStringStore.connect([s.address for s in servers])
        routers.append(second)
        stop = threading.Event()
        bg_calls: list = []

        def reader():
            try:
                j = 0
                while not stop.is_set():
                    ids = batches[j % len(batches)]
                    j += 1
                    check_strings("wire multiget beside the scan", second.multiget(ids),
                                  [strings[i] for i in ids])
                    bg_calls.append(ids)
            except Exception as e:
                errors.append(e)

        scans0 = sum(s.op_counts.get("scan", 0) for s in servers)
        b0, l0, s0 = svc_batches(), dc.launches, dt.launches
        bg = threading.Thread(target=reader)
        bg.start()
        t0 = time.perf_counter()
        scanned = dist.scan(0, n_all)
        scan_s = time.perf_counter() - t0
        bg_during = len(bg_calls)
        stop.set()
        bg.join(120)
        if bg.is_alive() or errors:
            raise AssertionError(f"wire: the reader beside the scan hung or failed: "
                                 f"{errors[:1]}")
        check_strings("wire scan(0, n)", scanned, strings)
        del scanned
        scan_rpcs = sum(s.op_counts.get("scan", 0) for s in servers) - scans0
        want_rpcs = sum(-(-(hi - lo) // dist.scan_chunk) for lo, hi in bounds)
        bg_expect = shard_calls(bg_calls)
        if scan_rpcs != want_rpcs or dt.launches - s0 != scan_rpcs or \
                (dc.launches - l0, svc_batches() - b0) != (bg_expect, bg_expect):
            raise AssertionError(f"wire: scan(0, n) took {scan_rpcs} RPCs (expected "
                                 f"{want_rpcs}) and {dt.launches - s0} stream launches; "
                                 f"the reader's {len(bg_calls)} calls made "
                                 f"{dc.launches - l0} decode launches in "
                                 f"{svc_batches() - b0} batches, expected {bg_expect}")

        # locate (misses first: every shard builds every segment's index)
        # and scan_prefix, before any append: the flat store's answers
        queries = miss_q[:WIRE_LOCATE_MISSES] + hit_q[:WIRE_LOCATE_HITS]
        want_loc = [None] * WIRE_LOCATE_MISSES + want_hits[:WIRE_LOCATE_HITS]
        e0, s0 = et.launches, dt.launches
        t0 = time.perf_counter()
        got_loc = [r for i in range(0, len(queries), MULTIGET_IDS)
                   for r in dist.locate_batch(queries[i : i + MULTIGET_IDS])]
        loc_s = time.perf_counter() - t0
        if got_loc != want_loc:
            raise AssertionError("wire: locate_batch differs from the flat store's")
        # a shard encodes the queries no earlier shard answered
        loc_encode = sum(
            encode_calls(pending)
            for i in range(0, len(queries), MULTIGET_IDS)
            for lo in shard_lo.tolist()
            for pending in ([q for q, a in zip(queries[i : i + MULTIGET_IDS],
                                               want_loc[i : i + MULTIGET_IDS])
                             if a is None or a >= lo],)
            if pending)
        index_builds = sum(s.store.segments.n_segments for s in servers)
        if (et.launches - e0, dt.launches - s0) != (loc_encode, index_builds):
            raise AssertionError(f"wire: locate made {et.launches - e0} encode and "
                                 f"{dt.launches - s0} stream launches, expected "
                                 f"{loc_encode} and {index_builds} index builds")
        prefix_ms, prefix_launches = [], 0
        for p, want, flat_launches in prefix_cases:
            l0 = dc.launches
            t0 = time.perf_counter()
            got = dist.scan_prefix(p, limit=PREFIX_LIMIT)
            prefix_ms.append((time.perf_counter() - t0) * 1e3)
            if got != want or dc.launches - l0 != flat_launches:
                raise AssertionError(f"wire: scan_prefix({p!r}) made {dc.launches - l0} "
                                     f"decode launches (flat store {flat_launches}), "
                                     f"answers equal: {got == want}")
            prefix_launches += flat_launches

        # extend onto the tail shard; each segment it seals is decoded once
        # for its index (the shard has located); read back
        tail = servers[-1].store
        segs0 = tail.segments.n_segments
        app = strings[:SERVE_EXTEND]
        e0, s0 = et.launches, dt.launches
        t0 = time.perf_counter()
        app_ids = [i for lo in range(0, SERVE_EXTEND, EXTEND_BATCH)
                   for i in dist.extend(app[lo : lo + EXTEND_BATCH])]
        extend_s = time.perf_counter() - t0
        tail.seal_barrier()
        seals = tail.segments.n_segments - segs0
        ext_encode = sum(encode_calls(app[lo : lo + EXTEND_BATCH])
                         for lo in range(0, SERVE_EXTEND, EXTEND_BATCH))
        if app_ids != list(range(n_all, n_all + SERVE_EXTEND)) or \
                (et.launches - e0, dt.launches - s0) != (ext_encode, seals) or \
                tail.n_strings != bounds[-1][1] - bounds[-1][0] + SERVE_EXTEND:
            raise AssertionError(f"wire: extend gave ids {app_ids[:2]}..., "
                                 f"{et.launches - e0} encode and {dt.launches - s0} "
                                 f"stream launches, expected {ext_encode} and {seals}")
        read_back = [np.asarray(app_ids[i : i + MULTIGET_IDS]) - bounds[-1][0]
                     for i in range(0, SERVE_EXTEND, MULTIGET_IDS)]
        l0 = dc.launches
        for local in read_back:
            check_strings("wire appended ids", dist.multiget((local + bounds[-1][0]).tolist()),
                          [app[i - n_all] for i in (local + bounds[-1][0]).tolist()])
        sealed = tail.n_sealed
        tail_calls = sum(bool((local >= sealed).any()) for local in read_back)
        read_launches = sum(bool((local < sealed).any()) for local in read_back) + tail_calls
        if dc.launches - l0 != read_launches:
            raise AssertionError(f"wire: reading the appends back made "
                                 f"{dc.launches - l0} decode launches, expected "
                                 f"{read_launches}")
        inproc_wall = time.perf_counter() - t_phase

        # the child server, over shard 0
        proc, port, mport, ready_s = await_child(child)
        cdist = DistributedStringStore.connect([("127.0.0.1", port)])
        routers.append(cdist)
        n0 = bounds[0][1] - bounds[0][0]
        perm = np.random.default_rng(SEED + 11).permutation(n0)
        calls = [perm[i : i + MULTIGET_IDS].tolist() for i in range(0, n0, MULTIGET_IDS)]

        def read_child() -> tuple[float, float]:
            """Every id of shard 0 through the router: (seconds of the
            first call, seconds of the rest)."""
            t0 = time.perf_counter()
            got = [cdist.multiget(calls[0])]
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            got += [cdist.multiget(ids) for ids in calls[1:]]
            rest = time.perf_counter() - t0
            for ids, g in zip(calls, got):
                check_strings("wire child multiget", g, [strings[i] for i in ids])
            return first, rest

        first_s, rest_s = read_child()
        text = fetch_metrics("127.0.0.1", mport)
        rows = parse_prometheus(text)
        reqs = find_series(rows, "repro_rpc_requests_total", {"op": "multiget"})
        hist = hist_state_from_rows(rows, "repro_service_request_latency_us")
        hcount = re.search(r"^repro_service_request_latency_us_count (\d+)$", text, re.M)
        traces = fetch_traces("127.0.0.1", mport, 4)
        health = fetch_text(f"http://127.0.0.1:{mport}/healthz")
        if [r["value"] for r in reqs] != [len(calls)] or hist is None or \
                hcount is None or sum(hist["counts"]) != int(hcount.group(1)) \
                or int(hcount.group(1)) != len(calls) or not isinstance(traces, list) \
                or health != "ok\n":
            raise AssertionError(f"wire: the child's /metrics counts {reqs} multiget "
                                 f"requests for {len(calls)} sent, its latency "
                                 f"histogram {hist and sum(hist['counts'])} in buckets, "
                                 f"count {hcount and hcount.group(1)}; /healthz {health!r}")
        # the child's device memory: the card's free memory before and after
        # it exits (this process is idle in between)
        free_alive = torch.cuda.mem_get_info()[0] if dev.type == "cuda" else 0
        proc.terminate()
        proc.wait(60)
        if dev.type == "cuda":
            time.sleep(1.0)  # an exited process's device memory frees a moment later
            freed = (torch.cuda.mem_get_info()[0] - free_alive) / 2**20
            mem_note = (f"the child held {freed:.1f} MiB of the card (free memory "
                        "before and after it exited), "
                        f"this process {torch.cuda.memory_reserved() / 2**20:.1f} MiB "
                        "reserved by torch besides its CUDA context")
        else:
            mem_note = "device memory not measured (no card)"
        _, port2, _, ready2_s = await_child(start_child(port))
        again_first_s, again_rest_s = read_child()
        reconnects = cdist.clients[0].reconnects
        if port2 != port or reconnects < 1:
            raise AssertionError(f"wire: the restarted child took port {port2} (was "
                                 f"{port}); the router reconnected {reconnects} times")

        phase = counts.end("wire", ["decode_compact", "encode_batch", "decode_tokens"])
        expect = {"decode_compact": mg_expect * win_runs + get_launches
                  + bg_expect + prefix_launches + read_launches,
                  "encode_batch": loc_encode + ext_encode,
                  "decode_tokens": scan_rpcs + index_builds + seals}
        if phase != expect:
            raise AssertionError(f"wire: launches {phase}, expected {expect}")
    finally:
        for r in routers:
            r.close()
        for srv in servers:
            srv.close()
        for p in children:
            if p.poll() is None:
                p.kill()
            p.wait(60)
        child_err.close()
        shutil.rmtree(wdir, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log("wire", f"[{card}] {SERVE_SHARDS} ShardServers in this process (writable, "
        f"cache_bytes=0) opened in {open_s:.3f} s; router multiget, every id in "
        f"{len(batches)} shuffled calls of {MULTIGET_IDS} under torch.profiler: "
        f"{n_all / mg_s:.1f} lookups/s, p50 {mg_p50:.3f} ms, p99 {mg_p99:.3f} ms a "
        f"call, {mg_expect} decode launches == a call per shard touched == the "
        f"servers' service batches; in-process ShardedStringStore "
        f"{sharded_rate:.1f} lookups/s (serve phase, same run)")
    log("wire", f"[{card}] the sweep's window: {mg_s:.3f} s wall, device busy {busy}, "
        f"runs {win_runs}; "
        + "; ".join(f"{k} {n} x, {sec:.4f} s" for k, (n, sec) in sorted(acts.items())))
    log("wire", f"[{card}] get() from {SERVE_CLIENTS} threads over {get_ids.size} ids: "
        f"{get_ids.size / get_wall:.1f} requests/s, p50 {get_p50:.1f} us, p99 "
        f"{get_p99:.1f} us; {get_batches} service batches == decode launches (avg "
        f"{get_ids.size / get_batches:.2f} a batch)")
    log("wire", f"[{card}] scan(0, n) through the router: "
        f"{throughput_mib_s(raw_bytes, scan_s):.1f} MiB/s ({scan_s:.3f} s), {scan_rpcs} "
        f"RPCs of {dist.scan_chunk} == stream launches; a second connection made "
        f"{bg_during} multigets during it ({len(bg_calls)} in all, {bg_expect} decode "
        "launches); bytes == the source")
    log("wire", f"[{card}] locate_batch of {WIRE_LOCATE_MISSES} misses then "
        f"{WIRE_LOCATE_HITS} hits: {len(queries) / loc_s:.1f} queries/s ({index_builds} "
        f"index builds, {loc_encode} encode launches == recomputed); scan_prefix of "
        f"{[p for p, _, _ in prefix_cases]}: "
        f"{', '.join(f'{ms:.1f}' for ms in prefix_ms)} ms, {prefix_launches} probes "
        "== the flat store's; answers == the flat store's")
    log("wire", f"[{card}] extend of {SERVE_EXTEND} strings onto the tail shard in "
        f"{extend_s:.3f} s ({SERVE_EXTEND / extend_s:.1f} strings/s, {ext_encode} "
        f"encode launches, {seals} seals); read back in {len(read_back)} calls "
        f"({read_launches} decode launches); in-process part {inproc_wall:.1f} s")
    log("wire", f"[{card}] child `python -m repro_torch.net` (shard 0, {n0} strings): "
        f"ready {ready_s:.2f} s after start; first 1,024-id call {first_s * 1e3:.1f} "
        f"ms, then {(len(calls) - 1) / rest_s:.1f} calls/s "
        f"({(n0 - len(calls[0])) / rest_s:.1f} lookups/s); /metrics multiget requests "
        f"{len(calls)} == sent, latency buckets sum == count; {mem_note}")
    log("wire", f"[{card}] child restarted on port {port} (ready {ready2_s:.2f} s after "
        f"start); read again: first call {again_first_s * 1e3:.1f} ms, then "
        f"{(len(calls) - 1) / again_rest_s:.1f} calls/s; router reconnects "
        f"{reconnects}; the phase's launches {phase}; the phase's wall {wall:.1f} s")


def client_phase(card: str, dev: torch.device, strings: list[bytes], store, batches,
                 counts: PathCounts) -> None:
    """Clients and load: ``repro_torch.client.connect`` over ``file://`` (the
    read store saved), ``mut://`` (a writable copy), ``shard://`` and
    ``tcp://`` (a ``LocalCluster`` of one ``python -m repro_torch.net`` child
    process a shard, on ``dev``), every id read back through each; then
    ``get_async`` coalescing, ``repro_torch.loadgen`` closed and open loops
    and its CLI over the cluster, and appends group-committed onto the tail
    shard's child. No profiled window: the wire's runs last among those.
    The decode launches of this process are checked against the client-owned
    services' batches (a call per shard touched for ``shard://``), and each
    child's ``/metrics`` decode counter against its service's batches."""
    from repro_torch.client import connect
    from repro_torch.distributed import save_sharded
    from repro_torch.kernels import onpair_decode
    from repro_torch.loadgen import (LocalCluster, WorkloadSpec, build_report,
                                     run_workload)
    from repro_torch.loadgen.cluster import READY_S
    from repro_torch.loadgen.slo import (collect_rpc_states, collect_scrape_states,
                                         shard_clients)
    from repro_torch.obs import fetch_metrics, find_series, parse_prometheus

    counts.start()
    t_phase = time.perf_counter()
    n_all = len(strings)
    dc = onpair_decode.decode_compact
    path, other = ("cuda", "ref") if dev.type == "cuda" else ("ref", "cuda")
    cdir = tempfile.mkdtemp(prefix="chip-smoke-client-")
    flat, mut = os.path.join(cdir, "flat"), os.path.join(cdir, "mut")
    shard_dir = os.path.join(cdir, "sharded")
    store.save(flat)
    shutil.copytree(flat, mut)  # a plain store dir opens writable too
    bounds = save_sharded(store, shard_dir, SERVE_SHARDS)
    shard_lo = np.asarray([lo for lo, _ in bounds], np.int64)
    spawned: dict = {}

    def spawn():
        try:
            t0 = time.perf_counter()
            spawned["cluster"] = LocalCluster.spawn(shard_dir, n_shards=SERVE_SHARDS,
                                                    device=dev.type)
            spawned["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised on the main thread
            spawned["error"] = e

    def shard_calls(id_batches) -> int:
        return sum(np.unique(np.searchsorted(shard_lo, np.asarray(ids),
                                             side="right")).size
                   for ids in id_batches)

    def sweep(client, what: str) -> float:
        """Every id in the read path's shuffled calls; the seconds."""
        t0 = time.perf_counter()
        got = [client.multiget(ids) for ids in batches]
        wall = time.perf_counter() - t0
        for ids, g in zip(batches, got):
            check_strings(f"client {what} multiget", g, [strings[i] for i in ids])
        return wall

    def child_counts(cluster) -> list[dict]:
        """Per child, the decode counter by path, from its /metrics."""
        out = []
        for h, p in cluster.metrics_addrs:
            rows = parse_prometheus(fetch_metrics(h, p))
            out.append({lab: sum(r["value"] for r in find_series(
                rows, "repro_kernel_decode_batches_total", {"path": lab}))
                for lab in ("cuda", "ref")})
        return out

    spawner = threading.Thread(target=spawn)
    spawner.start()  # the children start while the in-process frontends run
    cluster = None
    key_sets: dict = {}
    rates: dict = {}
    try:
        # ---- the in-process frontends, each over every id
        local = {}
        for scheme, url in (("file", f"file://{flat}"), ("mut", f"mut://{mut}"),
                            ("shard", f"shard://{shard_dir}")):
            l0 = dc.launches
            with connect(url, device=dev, cache_bytes=0) as client:
                wall = sweep(client, scheme)
                snap = client.stats()
                key_sets[scheme] = frozenset(snap)
                launches = dc.launches - l0
                if scheme == "shard":
                    batches_ = None
                    want = shard_calls(batches)
                else:
                    batches_ = snap["backend"]["service"]["batches"]
                    want = batches_
                if launches != want or (batches_ is not None and
                                        batches_ != len(batches)):
                    raise AssertionError(f"client {scheme}://: {launches} decode "
                                         f"launches, service batches {batches_}, "
                                         f"expected {want}")
            rates[scheme] = n_all / wall
            local[scheme] = (launches, batches_, wall)
        spawner.join(SERVE_SHARDS * READY_S + 60)  # each line has READY_S
        if "error" in spawned:
            raise spawned["error"]
        if spawner.is_alive() or "cluster" not in spawned:
            raise AssertionError("client: the cluster's spawn did not return")
        cluster = spawned["cluster"]
        tcp = connect(cluster.url, **cluster.connect_kw())
        try:
            if tcp.backend.bounds != bounds:
                raise AssertionError(f"client: the cluster's bounds {tcp.backend.bounds}")
            base = child_counts(cluster)
            svc0 = [c.stats()["service"] for c in shard_clients(tcp)]
            tcp_wall = sweep(tcp, "tcp")
            rates["tcp"] = n_all / tcp_wall
            key_sets["tcp"] = frozenset(tcp.stats())
            if len(set(key_sets.values())) != 1:
                raise AssertionError(f"client: the stats key sets differ: {key_sets}")

            # ---- get_async from threads: the client coalesces them
            get_ids = np.random.default_rng(SEED + 12).permutation(n_all)[:CLIENT_GET_IDS]
            errors: list = []

            def getter(share):
                try:
                    futs = [(i, tcp.get_async(i)) for i in share.tolist()]
                    for i, f in futs:
                        if f.result(120) != strings[i]:
                            raise AssertionError(f"client get_async({i}) differs")
                except Exception as e:
                    errors.append(e)

            st0 = tcp.stats()
            threads = [threading.Thread(target=getter, args=(get_ids[k::SERVE_CLIENTS],))
                       for k in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            get_wall = time.perf_counter() - t0
            raise_if_clients_failed("client: a get_async thread", threads, errors)
            st1 = tcp.stats()
            get_batches = st1["get_batches"] - st0["get_batches"]
            coalesced = st1["coalesced_gets"] - st0["coalesced_gets"]

            # ---- loadgen: closed loop, the servers' histograms both ways
            def both_ways():
                rpc = collect_rpc_states(shard_clients(tcp))
                scraped = collect_scrape_states(cluster.metrics_addrs)
                if rpc != scraped:
                    raise AssertionError("loadgen: the servers' histograms by the "
                                         "stats RPC differ from the scrape's")
                return rpc

            def loop(spec):
                before = both_ways()
                result = run_workload(tcp, spec, LOADGEN_S)
                after = both_ways()
                report = build_report(spec, result, before, after, client=tcp,
                                      metrics_addrs=cluster.metrics_addrs)
                if result.ops_failed or report["server_latency"]["count"] <= 0:
                    raise AssertionError(f"loadgen {spec.loop}: {result.ops_failed} "
                                         f"failed ops {result.first_errors[:2]}")
                return result, report

            closed, closed_rep = loop(WorkloadSpec(seed=SEED))
            open_rate = 0.5 * closed.achieved_rate
            opened, open_rep = loop(WorkloadSpec(loop="open", rate=open_rate,
                                                 seed=SEED))

            # ---- the CLI, attached to the running cluster
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "repro_torch.loadgen", "--url", cluster.url,
                 "--metrics-addrs", ",".join(f"{h}:{p}" for h, p in
                                             cluster.metrics_addrs),
                 "--duration", str(CLI_S)], capture_output=True, text=True,
                timeout=300, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
            cli_wall = time.perf_counter() - t0
            if cli.returncode not in (0, 1):
                raise AssertionError(f"loadgen CLI exited {cli.returncode}:\n"
                                     f"{cli.stderr[-4000:]}")
            cli_rep = json.loads(cli.stdout)
            if len(cluster.procs) != SERVE_SHARDS or \
                    cli_rep["run"]["ops_ok"] <= 0 or cli_rep["run"]["ops_failed"]:
                raise AssertionError(f"loadgen CLI: {cli_rep['run']}")

            # ---- appends group-committed onto the tail shard's child: one
            # length cap (<= 32 B), so an extend call is one encode launch
            tail_client = shard_clients(tcp)[-1]
            tail0 = tail_client.stats()
            app = [s for s in strings if 0 < len(s) <= 32][:CLIENT_APPENDS]
            e0 = tcp.stats()["extend_batches"]
            t0 = time.perf_counter()
            futs = [tcp.append_async(s) for s in app]
            app_ids = [f.result(120) for f in futs]
            app_wall = time.perf_counter() - t0
            extend_batches = tcp.stats()["extend_batches"] - e0
            if app_ids != list(range(n_all, n_all + len(app))):
                raise AssertionError(f"client: appends got ids {app_ids[:3]}...")
            deadline = time.perf_counter() + 120
            while True:  # the child seals off-thread: wait for its commit
                tail1 = tail_client.stats()
                if tail1["store"]["n_tail_strings"] < STRINGS_PER_SEGMENT or \
                        time.perf_counter() > deadline:
                    break
                time.sleep(0.05)
            append_batches = (tail1["service"]["append_batches"]
                              - tail0["service"]["append_batches"])
            appended = tail1["service"]["appends"] - tail0["service"]["appends"]
            if appended != len(app) or tail1["store"]["n_tail_strings"] >= \
                    STRINGS_PER_SEGMENT:
                raise AssertionError(f"client: the tail child took {appended} appends; "
                                     f"tail {tail1['store']['n_tail_strings']}")
            encode_expect = append_batches  # one launch an extend call
            sealed_local = tail1["store"]["n_sealed_strings"]
            lo_tail = bounds[-1][0]
            read_back = [app_ids[i : i + MULTIGET_IDS]
                         for i in range(0, len(app_ids), MULTIGET_IDS)]
            for ids in read_back:
                check_strings("client appended ids", tcp.multiget(ids),
                              [app[i - n_all] for i in ids])
            # a read-back call is one service batch of the tail child: one
            # decode launch for its sealed ids, one more for its tail ids
            both = sum(bool((np.asarray(ids) - lo_tail < sealed_local).any()) and
                       bool((np.asarray(ids) - lo_tail >= sealed_local).any())
                       for ids in read_back)

            # ---- every child: decode launches == its service's batches
            after = child_counts(cluster)
            svc1 = [c.stats()["service"] for c in shard_clients(tcp)]
            child_rows = []
            for k, (b, a, s0, s1) in enumerate(zip(base, after, svc0, svc1)):
                launches = a[path] - b[path]
                # a batch of reads is one launch; the appends drained alone
                # (nothing read meanwhile) are the tail child's write batches
                reads_k = s1["batches"] - s0["batches"] - (
                    s1["append_batches"] - s0["append_batches"])
                extra = both if k == SERVE_SHARDS - 1 else 0
                child_rows.append((int(launches), reads_k))
                if launches != reads_k + extra or a[other] != 0:
                    raise AssertionError(
                        f"client: child {k} made {launches} decode launches "
                        f"(repro_kernel_decode_batches_total{{path={path}}}) in "
                        f"{reads_k} service batches of reads (+{extra} read-back "
                        f"calls touching the sealed part and the tail); "
                        f"path={other} {a[other]}")
        finally:
            tcp.close()
        phase = counts.end("client", ["decode_compact"])
        expect = {"decode_compact": sum(l for l, _, _ in local.values()),
                  "encode_batch": 0, "decode_tokens": 0}
        if phase != expect:
            raise AssertionError(f"client: launches {phase}, expected {expect}")
    finally:
        spawner.join(300)
        cluster = cluster or spawned.get("cluster")
        if cluster is not None:
            procs = list(cluster.procs)
            cluster.close()
            if any(p.poll() is None for p in procs):
                raise AssertionError("client: a child outlived the cluster's close")
        shutil.rmtree(cdir, ignore_errors=True)
    wall = time.perf_counter() - t_phase

    def lat(summary: dict) -> str:
        return (f"p50 {summary['p50_us'] / 1e3:.3f} ms, p99 "
                f"{summary['p99_us'] / 1e3:.3f} ms")

    log("client", f"[{card}] connect() over every id in {len(batches)} shuffled calls "
        f"of {MULTIGET_IDS}: file:// {rates['file']:.1f}, mut:// {rates['mut']:.1f}, "
        f"shard:// {rates['shard']:.1f} lookups/s in this process (decode launches "
        f"{local['file'][0]} / {local['mut'][0]} == the client-owned services' "
        f"batches, {local['shard'][0]} == a call per shard touched); tcp:// over "
        f"{SERVE_SHARDS} `python -m repro_torch.net` child processes "
        f"{rates['tcp']:.1f} lookups/s; bytes == the source; the stats key sets "
        f"equal across the four ({len(key_sets['tcp'])} keys)")
    log("client", f"[{card}] the {SERVE_SHARDS} children ready {spawned['seconds']:.2f} s "
        f"after their start (started together, beside the in-process sweeps); "
        f"per child, decode launches (/metrics path={path}) / service batches of "
        f"reads: "
        + ", ".join(f"{l} / {b}" for l, b in child_rows)
        + f" (the tail child +{both} read-back calls touching both its sealed part "
        f"and its tail); path={other} 0 in every child")
    log("client", f"[{card}] get_async from {SERVE_CLIENTS} threads over "
        f"{get_ids.size} ids: {get_ids.size / get_wall:.1f} requests/s, "
        f"{get_batches} client batches ({coalesced} gets answered in batches of "
        f"more than one, avg {get_ids.size / get_batches:.1f} a batch)")
    log("client", f"[{card}] {len(app)} append_async (strings of 1-32 B) in "
        f"{app_wall:.3f} s ({len(app) / app_wall:.1f} appends/s): {extend_batches} "
        f"client extend batches, {append_batches} extend calls in the tail child == "
        f"{encode_expect} encode launches there (recomputed: one a call, one length "
        f"cap); read back in {len(read_back)} calls, bytes == the source")
    for name, res, rep in (("closed", closed, closed_rep), ("open", opened, open_rep)):
        s, c = rep["server_latency"], res.summary()["client_latency"]
        log("loadgen", f"[{card}] {name} loop, {LOADGEN_S:.0f} s of the "
            f"default mix (70/30 get/multiget, zipf 1.1"
            + (f", concurrency {WorkloadSpec().concurrency}" if name == "closed" else
               f", {open_rate:.1f} arrivals/s = half the closed loop's rate")
            + f"): {res.achieved_rate:.1f} ops/s achieved, {res.ops_ok} ok, "
            f"{res.ops_failed} failed, late {res.late}; client {lat(c)}; servers "
            f"(merged, stats RPC == scrape) {lat(s)}, p999 {s['p999_us'] / 1e3:.3f} "
            f"ms over {s['count']} requests; goodput {rep['goodput']['rps_under_slo']} "
            f"ops/s under the {rep['slo']['p99_ms']} ms p99 (passed: {rep['passed']})")
    log("loadgen", f"[{card}] `python -m repro_torch.loadgen --url` attached for "
        f"{CLI_S:.0f} s (no spawn of its own): exit {cli.returncode}, "
        f"{cli_rep['run']['achieved_rate']} ops/s, servers p99 "
        f"{cli_rep['server_latency']['p99_us'] / 1e3:.3f} ms; {cli_wall:.1f} s with "
        f"its start-up; the phase's launches in this process {phase}; the phase's "
        f"wall {wall:.1f} s")


def lm_phase(card: str, dev: torch.device, counts: PathCounts) -> dict:
    """The LM serving path (``repro_torch.launch.serve``'s LM role): every
    architecture at its smoke config in fp32 on the card against the same
    weights on the host (TF32 off), then bf16 on the card; mamba2-780m at
    full width through ``serve_lm`` with ``--doc-ids`` (the store built on
    the encode kernel, the prompts fetched by one multiget on the decode
    kernel), in bf16; the same weights in fp32 on the card and on the host
    over its prompt batch; and prefill against decode at full width on the
    card; one more bf16 step of the launcher's weights and cache under the
    profiler, beside its bound. Every check raises. Returns the host's fp32
    draw of the full-width weights (``host``), for the train phase, and the
    fp32 card run over the prompt batch (``fp32_card``: its tokens, the ids
    fed to its decode steps and its logits), for the dist phase."""
    from dataclasses import replace

    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.data.synth import load_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CORPUS_BYTES, build_parser, serve_lm
    from repro_torch.models.model import (build_params, demo_batch, model_forward,
                                          serve_decode, serve_prefill, to_device)

    t_phase = time.perf_counter()
    host = torch.device("cpu")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
        """Max absolute error over the max absolute value of ``want``."""
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max() / want.abs().max())

    def agree(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
        """The card's logits against the host's, within the CPU tests'
        whole-model tolerance; greedy ids equal."""
        got = got.float().cpu()
        if got.shape != want.shape or not torch.allclose(
                got, want, rtol=LM_SMOKE_TOL, atol=LM_SMOKE_TOL):
            raise AssertionError(f"lm {what}: card and host logits differ beyond "
                                 f"{LM_SMOKE_TOL} (max abs err "
                                 f"{(got - want).abs().max():.3e})")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"lm {what}: greedy ids differ")
        return rel_err(got, want)

    def finite(what: str, t: torch.Tensor, shape: tuple) -> None:
        if tuple(t.shape) != shape or not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"lm {what}: {tuple(t.shape)} (expected {shape}) "
                                 "or a value that is not finite")

    try:
        with torch.inference_mode():
            # ---- 1. every architecture at its smoke config
            t0 = time.perf_counter()
            worst = {}
            for name in sorted(REGISTRY):
                cfg = replace(REGISTRY[name].smoke(), dtype="float32")
                p_host = build_params(cfg, seed=0, device=host)
                p_card = to_device(p_host, dev)
                batch = demo_batch(cfg, 2, 32, kind="train", device=host)
                errs = [agree(f"{name} forward",
                              model_forward(p_card, to_device(batch, dev), cfg),
                              model_forward(p_host, batch, cfg))]
                pb = demo_batch(cfg, 2, 16, kind="prefill", seed=1, device=host)
                lh, ch = serve_prefill(p_host, pb, cfg, max_seq=LM_SMOKE_MAX_SEQ)
                lc, cc = serve_prefill(p_card, to_device(pb, dev), cfg,
                                       max_seq=LM_SMOKE_MAX_SEQ)
                errs.append(agree(f"{name} prefill", lc, lh))
                for step in range(LM_SMOKE_DECODE):  # past max_seq from step 4
                    tok = lh.argmax(-1)[:, None].to(torch.int32)
                    lh, ch = serve_decode(p_host, ch, {"token": tok}, cfg)
                    lc, cc = serve_decode(p_card, cc, {"token": tok.to(dev)}, cfg)
                    errs.append(agree(f"{name} decode step {step}", lc, lh))
                worst[name] = max(errs)
                # bf16 on the card: shapes and finiteness
                cfg16 = REGISTRY[name].smoke()
                p16 = build_params(cfg16, seed=0, device=dev)
                V = cfg16.vocab_size
                finite(f"{name} bf16 forward", model_forward(
                    p16, demo_batch(cfg16, 2, 32, device=dev), cfg16), (2, 32, V))
                lg, c16 = serve_prefill(
                    p16, demo_batch(cfg16, 2, 16, kind="prefill", seed=1, device=dev),
                    cfg16, max_seq=LM_SMOKE_MAX_SEQ)
                finite(f"{name} bf16 prefill", lg, (2, V))
                for step in range(LM_SMOKE_DECODE):
                    lg, c16 = serve_decode(p16, c16, {"token": lg.argmax(-1)[:, None]
                                                      .to(torch.int32)}, cfg16)
                    finite(f"{name} bf16 decode step {step}", lg, (2, V))
            torch.cuda.synchronize()
            log("lm", f"[{card}] {len(worst)} smoke configs, fp32 on the card == the "
                f"host within rtol=atol={LM_SMOKE_TOL} and equal greedy ids over "
                f"forward, prefill (S 16, max_seq {LM_SMOKE_MAX_SEQ}) and "
                f"{LM_SMOKE_DECODE} decode steps; max abs err / max |logit| per "
                "arch: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                + f"; bf16 on the card finite; {time.perf_counter() - t0:.1f} s")

        # ---- 2. mamba2-780m at full width through the launcher's LM role
        args = build_parser().parse_args(
            ["--arch", LM_ARCH, "--doc-ids", *map(str, LM_DOC_IDS),
             "--max-new", str(LM_MAX_NEW)])
        corpus = load_dataset("book_titles", CORPUS_BYTES)
        want_encode = len(encode_launch_shapes(corpus, ops._ENCODE_LEN_BUCKETS,
                                               ops._ENCODE_PAD_BATCH,
                                               ops._ENCODE_CHUNK_BYTES))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.start()
        t0 = time.perf_counter()
        out = serve_lm(args, dev)
        serve_s = time.perf_counter() - t0
        launches = counts.end("lm", ["decode_compact", "encode_batch"])
        peak = torch.cuda.max_memory_allocated()
        cfg = out["cfg"]
        if cfg != replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE):
            raise AssertionError(f"lm: not {LM_ARCH} at full width: {cfg}")
        check_strings("lm --doc-ids prompts", out["docs"],
                      [corpus[i] for i in LM_DOC_IDS])
        if launches != {"decode_compact": 1, "encode_batch": want_encode,
                        "decode_tokens": 0}:
            raise AssertionError(f"lm: launches {launches}, expected one multiget "
                                 f"(1 decode launch) and {want_encode} encode "
                                 "launches for the store build")
        B = len(out["ids"])
        if not out["logits_finite"] or out["generated"].shape != (B, LM_MAX_NEW):
            raise AssertionError("lm: a logit that is not finite, or "
                                 f"{out['generated'].shape} generated ids")
        n_tok = LM_MAX_NEW * B
        log("lm", f"[{card}] {LM_ARCH} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, ssm_state {cfg.ssm_state}, vocab {cfg.vocab_size}, "
            f"{cfg.dtype}) through serve_lm --doc-ids {LM_DOC_IDS} --max-new "
            f"{LM_MAX_NEW}: prompts {tuple(out['tokens'].shape)}, fetched docs == "
            f"the corpus strings; prefill {out['prefill_s']:.4f} s, decode "
            f"{n_tok} tokens in {out['decode_s']:.4f} s ({n_tok / out['decode_s']:.1f} "
            f"tok/s, {out['decode_s'] / LM_MAX_NEW * 1e3:.2f} ms a step of batch "
            f"{B}); serve_lm {serve_s:.1f} s in all (tokenizer, weights, store); peak "
            f"device memory {peak / 2**30:.3f} GiB; launches {launches} (encode "
            f"recomputed from the 1 MiB corpus's length caps)")
        # where a served decode step's time goes: one more bf16 step of the
        # launcher's own weights and cache under the profiler
        p16, c16 = out.pop("params"), out.pop("cache")
        tok = torch.from_numpy(out["generated"][:, -1:]).to(dev, torch.int32)
        with torch.inference_mode():
            (wall, acts), _, _ = device_window(
                lambda: serve_decode(p16, c16, {"token": tok}, cfg))
        step_bytes = lm_step_bytes(p16, c16, cfg, B)
        del p16, c16
        n_rec = sum(n for n, _ in acts.values())
        busy = sum(sec for _, sec in acts.values())
        log("lm", f"[{card}] one bf16 decode step of the launcher's batch {B} "
            f"under torch.profiler: wall {wall * 1e3:.2f} ms, {n_rec} device "
            f"records ({', '.join(f'{k} {n}' for k, (n, _) in acts.items())}), "
            f"device time {busy * 1e3:.3f} ms, busy {busy / wall:.2%}; bound "
            f"{step_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({step_bytes / 1e9:.3f} GB: "
            "the weights, the cache read and its state written)")

        # ---- 3. the same weights in fp32, on the card and on the host
        with torch.inference_mode():
            t0 = time.perf_counter()
            cfg32 = replace(cfg, dtype="float32")
            p_host = build_params(cfg32, seed=0, device=host)
            p_card = to_device(p_host, dev)
            tokens = torch.from_numpy(out["tokens"])
            lh, ch = serve_prefill(p_host, {"tokens": tokens}, cfg32,
                                   max_seq=args.max_seq)
            lc, cc = serve_prefill(p_card, {"tokens": tokens.to(dev)}, cfg32,
                                   max_seq=args.max_seq)
            errs = [rel_err(lc, lh)]
            same = [bool(torch.equal(lc.argmax(-1).cpu(), lh.argmax(-1)))]
            # the one-device card run the dist phase's tensor-parallel ranks
            # are held to: the prompt batch, the ids fed, the card's logits
            fp32_card = {"tokens": tokens.clone(), "max_seq": args.max_seq,
                         "ids": [], "logits": [lc.cpu()]}
            for _ in range(LM_FP32_DECODE):
                tok = lh.argmax(-1)[:, None].to(torch.int32)  # the host's ids
                lh, ch = serve_decode(p_host, ch, {"token": tok}, cfg32)
                lc, cc = serve_decode(p_card, cc, {"token": tok.to(dev)}, cfg32)
                errs.append(rel_err(lc, lh))
                same.append(bool(torch.equal(lc.argmax(-1).cpu(), lh.argmax(-1))))
                fp32_card["ids"].append(tok.clone())
                fp32_card["logits"].append(lc.cpu())
            del ch, lh
            card_vs_host = max(errs)
            log("lm", f"[{card}] {LM_ARCH} fp32 at full width, card vs host (TF32 "
                f"off) over the {tuple(tokens.shape)} prompt batch, prefill + "
                f"{LM_FP32_DECODE} decode steps: max abs err / max |logit| "
                f"{card_vs_host:.3e} (per call {', '.join(f'{e:.2e}' for e in errs)}; "
                f"gate {LM_GATE}); greedy ids equal {same}; "
                f"{time.perf_counter() - t0:.1f} s")
            if card_vs_host > LM_GATE:
                raise AssertionError(f"lm: fp32 card vs host {card_vs_host:.3e} > "
                                     f"{LM_GATE}")

            # ---- 4. prefill against decode, fp32 on the card
            lc, cc = serve_prefill(p_card, {"tokens": tokens.to(dev)}, cfg32,
                                   max_seq=args.max_seq)
            gen = []
            for _ in range(LM_FP32_DECODE):
                tok = lc.argmax(-1)[:, None].to(torch.int32)
                gen.append(tok)
                lc, cc = serve_decode(p_card, cc, {"token": tok}, cfg32)
            longer = torch.cat([tokens.to(dev)] + gen, dim=1)
            lp, _ = serve_prefill(p_card, {"tokens": longer}, cfg32,
                                  max_seq=args.max_seq)
            pf_vs_dec = rel_err(lc, lp)
            log("lm", f"[{card}] {LM_ARCH} fp32 on the card: prefill + "
                f"{LM_FP32_DECODE} decode steps vs prefill of the "
                f"{tuple(longer.shape)} prompt + generated ids, last position: "
                f"max abs err / max |logit| {pf_vs_dec:.3e} (gate {LM_GATE}); greedy "
                f"ids equal {bool(torch.equal(lc.argmax(-1), lp.argmax(-1)))}")
            if pf_vs_dec > LM_GATE:
                raise AssertionError(f"lm: prefill vs decode {pf_vs_dec:.3e} > "
                                     f"{LM_GATE}")
            del p_card, cc, lc, lp
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.empty_cache()
    log("lm", f"the phase's wall {time.perf_counter() - t_phase:.1f} s")
    return {"host": p_host, "fp32_card": fp32_card}


def train_phase(card: str, dev: torch.device, counts: PathCounts,
                lm_host: dict | None = None,
                dry: subprocess.Popen | None = None,
                wait_for: list[subprocess.Popen] = ()) -> dict:
    """The LM training path (``python -m repro_torch.launch.train``).

    (a) Every architecture at its smoke config in fp32 (TF32 off), from a
    state at step ``TRAIN_STEP0``: the loss and every gradient leaf, then
    one ``make_train_step`` step (the loss, the parameters, both moments),
    on the card against the same state on the host within ``TRAIN_TOL`` of
    each leaf's largest value; one step with q8 moments (``q`` within one
    quantum); one of 2 microbatches on the card (its loss within
    ``TRAIN_MB_RTOL`` of one batch's); one bf16 step on the card, finite.
    (b) The launcher in child processes on the card at smoke width: 9 steps
    with one checkpoint, at step 6, then 9 on the same directory (resumed
    from 6, 3 steps; its step-6 loss within ``TRAIN_RESUME_RTOL`` of the
    first, uninterrupted run's, which came from the state the checkpoint
    holds; the later ones within ``TRAIN_LATER_RTOL``); a child
    sent SIGTERM after step 10 saves and exits 0; a checkpoint written on
    the card restores on the host to equal leaves.
    (c) mamba2-780m at full width in bf16 through ``train_lm`` (batch
    ``TRAIN_BATCH`` x seq ``TRAIN_SEQ``, ``TRAIN_STEPS`` steps, nothing
    saved): every loss finite; the step's wall (median of steps 2-8),
    tokens/s and peak device memory; one more step under the profiler,
    beside its bound (:func:`train_step_bound`).
    (d) The same config in fp32, batch 1 x seq 32, card against host: the
    loss and every gradient leaf within ``TRAIN_GATE`` of the leaf's
    largest value (``lm_host``: the lm phase's host draw of the weights).
    (d) runs while the children of (b) do; (c) after they, and the
    processes in ``wait_for`` (the dist phase's ranks), have exited.
    The dry-run of (c)'s step (``dry``, the ``--dryrun-probe`` child on the
    host, started here if not before) prints its roofline terms beside the
    bound. No kernel of the port is on
    this path: the counts must stay 0. Every check raises. Returns (c)'s
    losses and step wall."""
    import signal
    from dataclasses import replace

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.launch.train import build_parser, train_lm
    from repro_torch.models.model import build_params, demo_batch, to_device
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.state import make_abstract_state, make_state
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    t_phase = time.perf_counter()
    host = torch.device("cpu")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-")
    children: list[subprocess.Popen] = []

    def tree_err(got, want, what: str, tol: float) -> float:
        """Max over the leaves of max |got - want| / max |want|; raise past
        ``tol``. q8 ``q`` leaves may differ by one quantum."""
        g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
        if g.keys() != w.keys():
            raise AssertionError(f"train {what}: the trees' keys differ")
        worst = 0.0
        for k in w:
            a = g[k]
            b = w[k].to(a.device)  # compared where ``got`` lies, in fp32
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"train {what} {k}: {tuple(a.shape)} {a.dtype} "
                                     f"against {tuple(b.shape)} {b.dtype}")
            if k.endswith("/q"):
                if (a.int() - b.int()).abs().max() > 1:
                    raise AssertionError(f"train {what} {k}: q8 more than one "
                                         "quantum apart")
                continue
            a, b = a.float(), b.float()
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            if not err <= tol:  # NaN fails too
                raise AssertionError(f"train {what} {k}: {err:.3e} of the leaf's "
                                     f"largest value > {tol}")
            worst = max(worst, err)
        return worst

    def first_step(grads, opt) -> dict:
        """Adam's first step direction from ``grads`` (fp64, by path): with
        zero moments m^ = g and v^ = g^2 after the clip, so the step is
        g / (|g| + eps)."""
        flat = dict(leaves_with_paths(grads))
        norm = sum(float(g.double().square().sum()) for g in flat.values()) ** 0.5
        clip = min(1.0, opt.grad_clip / (norm + 1e-9))
        return {k: (g.cpu().double() * clip) / ((g.cpu().double() * clip).abs()
                                                + opt.eps) for k, g in flat.items()}

    def params_err(got, want, step_c: dict, step_h: dict, lr: float,
                   what: str) -> tuple[float, int]:
        """Updated parameters, card against host: within ``TRAIN_TOL`` of the
        leaf's largest value beyond what the two sides' first steps, each
        from its own gradients, set apart (lr |step_c - step_h|). Near
        |g| = eps a step moves by about a quarter for a gradient change of
        eps, so gradients equal within ``TRAIN_TOL`` may still step apart
        there. Returns the worst error beyond that and the count of entries
        where the steps' difference exceeds ``TRAIN_TOL`` of the leaf."""
        g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
        worst, apart = 0.0, 0
        for k in w:
            a, b = g[k].cpu().double(), w[k].cpu().double()
            scale = max(float(b.abs().max()), 1e-30)
            allowed = lr * (step_c[k] - step_h[k]).abs() * (1 + 1e-6)
            err = float(((a - b).abs() - allowed).max()) / scale
            if not err <= TRAIN_TOL:
                raise AssertionError(f"train {what} {k}: {err:.3e} of the leaf's "
                                     f"largest value > {TRAIN_TOL} beyond the "
                                     "steps' own difference")
            worst = max(worst, err)
            apart += int((allowed > TRAIN_TOL * scale).sum())
        return worst, apart

    def finite_tree(what: str, tree) -> None:
        bad = [k for k, t in leaves_with_paths(tree)
               if t.is_floating_point() and not bool(torch.isfinite(t.float()).all())]
        if bad:
            raise AssertionError(f"train {what}: not finite in {bad[:3]}")

    def start(name: str, extra: list[str], ckpt_dir: str | None = None
              ) -> subprocess.Popen:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CHILD_ARGS,
             "--ckpt-dir", os.path.join(tmp, ckpt_dir or name),
             "--stats-json", os.path.join(tmp, f"{name}.json"), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        children.append(proc)
        return proc

    def finish(name: str, proc: subprocess.Popen) -> dict:
        out, err = proc.communicate(timeout=TRAIN_CHILD_S)
        if proc.returncode != 0:
            raise AssertionError(f"train child {name} exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        with open(os.path.join(tmp, f"{name}.json")) as f:
            return {"stdout": out, **json.load(f)}

    try:
        if dry is None:
            dry = start_dryrun_probe()
        children.append(dry)
        # ---- (b) children first: they train their tokenizers on the host
        # while (a) and (d) run; the full-width run (c) waits for all of them
        # 9 uninterrupted steps with one checkpoint, at step 6: the resumed
        # run restores it, and its losses must be this run's
        first = start("a", ["--steps", "9", "--ckpt-every", "6"])
        term = start("t", ["--steps", "100000", "--ckpt-every", "100000"])
        term_lines: list[str] = []

        def watch_term() -> None:
            # SIGTERM once the child has logged its 10th step
            for line in term.stdout:
                term_lines.append(line)
                if line.startswith("step 10:"):
                    term.send_signal(signal.SIGTERM)

        watcher = threading.Thread(target=watch_term, daemon=True)
        watcher.start()
        chained: dict = {}

        def chain() -> None:
            # the resumed run starts as soon as the first one has saved
            try:
                chained["a"] = finish("a", first)
                chained["b"] = finish("b", start("b", ["--steps", "9", "--ckpt-every",
                                                       "3"], "a"))
            except Exception as exc:  # re-raised on the main thread
                chained["error"] = exc

        chainer = threading.Thread(target=chain, daemon=True)
        chainer.start()

        # ---- (a) every architecture at its smoke config, card against host
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        worst: dict[str, float] = {}
        apart: dict[str, int] = {}  # entries whose two first steps differ visibly
        last_bf16 = None
        for name in sorted(REGISTRY):
            cfg = replace(REGISTRY[name].smoke(), dtype="float32")
            base = build_params(cfg, seed=0, device=host)
            batch = demo_batch(cfg, 2, 32, kind="train", device=host)
            card_batch = to_device(batch, dev)

            def fresh(opt, where):
                p = to_device(tree_map(torch.clone, base), where)
                return {"params": p, "opt": init_state(p, opt),
                        "step": torch.tensor(TRAIN_STEP0, dtype=torch.int32,
                                             device=where)}

            lh, gh = loss_and_grads(base, batch, cfg)
            lc, gc = loss_and_grads(to_device(base, dev), card_batch, cfg)
            errs = [abs(float(lc) - float(lh)) / abs(float(lh)),
                    tree_err(gc, gh, f"{name} grads", TRAIN_TOL)]
            steps = (first_step(gc, AdamWConfig()), first_step(gh, AdamWConfig()))
            if errs[0] > TRAIN_TOL:
                raise AssertionError(f"train {name}: loss {float(lc)} on the card, "
                                     f"{float(lh)} on the host")
            for quant in (False, True):
                opt = AdamWConfig(quantized_moments=quant)
                sh, mh = make_train_step(cfg, opt)(fresh(opt, host), batch)
                sc, mc = make_train_step(cfg, opt)(fresh(opt, dev), card_batch)
                p_err, n_apart = params_err(sc["params"], sh["params"], steps[0],
                                            steps[1], opt.lr * float(mh["lr_scale"]),
                                            f"{name} q8={quant} params")
                errs += [p_err, tree_err(sc["opt"], sh["opt"],
                                         f"{name} q8={quant} moments", TRAIN_TOL)]
                apart[name] = apart.get(name, 0) + n_apart
                if abs(float(mc["loss"]) - float(mh["loss"])) > \
                        TRAIN_TOL * abs(float(mh["loss"])):
                    raise AssertionError(f"train {name} q8={quant}: step loss "
                                         f"{float(mc['loss'])} against {float(mh['loss'])}")
                if int(sc["step"]) != TRAIN_STEP0 + 1 or int(sc["opt"]["count"]) != 1:
                    raise AssertionError(f"train {name}: step or count not advanced")
                if not quant:
                    one = float(mc["loss"])
            # 2 microbatches: card against host, and against one batch where
            # no MoE capacity (set by the tokens a call sees) drops differently
            opt = AdamWConfig()
            s2h, m2h = make_train_step(cfg, opt, microbatches=2)(fresh(opt, host), batch)
            s2c, m2c = make_train_step(cfg, opt, microbatches=2)(fresh(opt, dev),
                                                                 card_batch)
            errs.append(tree_err(s2c["opt"], s2h["opt"], f"{name} 2 microbatches' "
                                 "moments", TRAIN_TOL))
            mb = float(m2c["loss"])
            if abs(mb - float(m2h["loss"])) > TRAIN_TOL * abs(mb) or (
                    not cfg.n_experts and abs(mb - one) > TRAIN_MB_RTOL * abs(one)):
                raise AssertionError(f"train {name}: 2 microbatches' loss {mb} on "
                                     f"the card, {float(m2h['loss'])} on the host, "
                                     f"one batch's {one}")
            worst[name] = max(errs)
            # bf16 on the card: a step from step TRAIN_STEP0, finite
            cfg16 = REGISTRY[name].smoke()
            s16 = make_state(cfg16, opt, seed=0, device=dev)
            s16["step"].fill_(TRAIN_STEP0)
            s16, m16 = make_train_step(cfg16, opt)(s16, demo_batch(cfg16, 2, 32,
                                                                   device=dev))
            if not np.isfinite(float(m16["loss"])):
                raise AssertionError(f"train {name} bf16: loss {float(m16['loss'])}")
            finite_tree(f"{name} bf16 state", s16)
            last_bf16 = s16
        torch.cuda.synchronize()
        log("train", f"[{card}] {len(worst)} smoke configs in fp32 (TF32 off), a "
            f"step from step {TRAIN_STEP0} on the card == the host within "
            f"{TRAIN_TOL} of each leaf's largest value: the loss, every gradient, "
            "the updated parameters and both moments (plain and q8, q within one "
            "quantum), and of 2 microbatches, whose loss is within "
            f"{TRAIN_MB_RTOL} of one batch's but with MoE; worst error per arch: "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + "; parameter entries whose first steps, each from its side's "
            f"gradients, differ by more than {TRAIN_TOL} of the leaf (|g| near "
            "eps; plain + q8 steps): " + ", ".join(f"{k} {v}" for k, v in apart.items())
            + f"; bf16 on the card finite; {time.perf_counter() - t0:.1f} s")

        # a checkpoint written from the card restores on the host to equal leaves
        d = ckpt.save(last_bf16, 1, os.path.join(tmp, "card"))
        back, _ = ckpt.restore(os.path.dirname(d), tree_map(
            lambda t: torch.empty_like(t, device="meta"), last_bf16), device=host)
        for (k, a), (_, b) in zip(leaves_with_paths(back), leaves_with_paths(last_bf16)):
            if a.device.type != "cpu" or not torch.equal(a, b.cpu()):
                raise AssertionError(f"train checkpoint {k}: the host's restore "
                                     "differs from the card's state")
        del last_bf16, back

        # ---- (d) full width in fp32, card against host, while the children
        # of (b) run (nothing here is timed)
        t0 = time.perf_counter()
        cfg32 = replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE, dtype="float32")
        # the lm phase drew its weights under inference_mode: a clone outside
        # it is an ordinary tensor, which autograd may take
        p_host = tree_map(torch.clone, lm_host) if lm_host is not None else \
            build_params(cfg32, seed=0, device=host)
        batch = demo_batch(cfg32, 1, 32, kind="train", device=host)
        t1 = time.perf_counter()
        lh, gh = loss_and_grads(p_host, batch, cfg32)
        t2 = time.perf_counter()
        lc, gc = loss_and_grads(to_device(p_host, dev), to_device(batch, dev), cfg32)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
        grad_err = tree_err(gc, gh, f"{LM_ARCH} fp32 grads", TRAIN_GATE)
        split = (f"weights {t1 - t0:.1f} s, host gradients {t2 - t1:.1f} s, the "
                 f"card's (with the copy) {t3 - t2:.1f} s, the comparison "
                 f"{time.perf_counter() - t3:.1f} s")
        if loss_err > TRAIN_GATE:
            raise AssertionError(f"train: full-width fp32 loss {float(lc)} on the "
                                 f"card, {float(lh)} on the host")
        del gh, gc, p_host
        log("train", f"[{card}] {LM_ARCH} fp32 at full width, batch 1 x seq 32, card "
            f"vs host (TF32 off): loss {float(lc):.6f} vs {float(lh):.6f} (relative "
            f"{loss_err:.2e}); gradients, max abs err / the leaf's max |value| "
            f"{grad_err:.3e} (gate {TRAIN_GATE}); {time.perf_counter() - t0:.1f} s "
            f"({split})")
        # ---- (b) resume and preemption through the launcher's children
        t0 = time.perf_counter()
        chainer.join(timeout=2 * TRAIN_CHILD_S)
        if chainer.is_alive() or "error" in chained:
            raise AssertionError(f"train resume children: {chained.get('error')!r}")
        a, resumed = chained["a"], chained["b"]
        rc_t = term.wait(timeout=TRAIN_CHILD_S)
        watcher.join(timeout=30)
        t_err = term.stderr.read()
        if rc_t != 0 or watcher.is_alive():
            raise AssertionError(f"train SIGTERM child exited {rc_t}: {t_err[-2000:]}")
        saved = [ln for ln in term_lines if ln.startswith("[preempt] saved step ")]
        if len(saved) != 1:
            raise AssertionError(f"train SIGTERM child: {len(saved)} preempt lines")
        t_step = int(saved[0].split()[3])
        if t_step < 10 or ckpt.latest_step(os.path.join(tmp, "t")) != t_step:
            raise AssertionError(f"train SIGTERM child: saved step {t_step}, latest "
                                 f"{ckpt.latest_step(os.path.join(tmp, 't'))}")
        if a["steps_run"] != 9 or resumed["resumed_from"] != 6 \
                or resumed["steps_run"] != 3:
            raise AssertionError(f"train resume: steps {a['steps_run']}, then "
                                 f"{resumed['steps_run']} resumed from "
                                 f"{resumed['resumed_from']}")
        if "resumed_from=6" not in resumed["stdout"]:
            raise AssertionError("train resume: the done line lacks resumed_from=6")
        # step 6 is restored state and a batch that is a function of the
        # step: the same loss; the later steps follow their own backwards
        rel = [abs(g - w) / abs(w) for g, w in zip(resumed["losses"], a["losses"][6:])]
        if rel[0] > TRAIN_RESUME_RTOL or max(rel) > TRAIN_LATER_RTOL:
            raise AssertionError(f"train resume: losses {resumed['losses']} against "
                                 f"the uninterrupted run's {a['losses'][6:]}")
        cfg_s = replace(REGISTRY[LM_ARCH].smoke(), vocab_size=VOCAB_SIZE)
        abstract = make_abstract_state(cfg_s, AdamWConfig())
        on_host, s_h = ckpt.restore(os.path.join(tmp, "a"), abstract, device=host)
        on_card, s_c = ckpt.restore(os.path.join(tmp, "a"), abstract, device=dev)
        if not s_h == s_c == 9 or not all(torch.equal(x, y.cpu()) for x, y in zip(
                leaves(on_host), leaves(on_card))):
            raise AssertionError("train: the card's checkpoint restores differently "
                                 "on the host and on the card")
        del on_host, on_card
        log("train", f"[{card}] launcher children on the card ({' '.join(TRAIN_CHILD_ARGS)}): "
            f"9 steps with a checkpoint at step 6, then 9 on its directory, resumed "
            f"from {resumed['resumed_from']} ({resumed['steps_run']} steps; losses "
            f"{resumed['losses']} against the uninterrupted run's {a['losses'][6:]}: "
            f"relative {', '.join(f'{x:.2e}' for x in rel)}); "
            "SIGTERM after step 10: saved step "
            f"{t_step}, exit 0; the step-9 checkpoint restores on the host == on the "
            f"card; a bf16 card state saved and restored on the host == its leaves; "
            f"{time.perf_counter() - t0:.1f} s after (a)")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for proc in wait_for:  # the dist phase reads and checks them
            try:
                proc.wait(timeout=TP_CHILD_S)
            except subprocess.TimeoutExpired:
                pass

        # ---- (c) mamba2-780m at full width through the launcher, bf16
        args = build_parser().parse_args(
            ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every",
             str(TRAIN_STEPS + 1), "--ckpt-dir", os.path.join(tmp, "full")])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts.start()
        t0 = time.perf_counter()
        out = train_lm(args, dev, install_signals=False)
        run_s = time.perf_counter() - t0
        counts.end("train", [])  # no kernel of the port on this path
        peak = torch.cuda.max_memory_allocated() - base_mem
        cfg, stats = out["cfg"], out["loop"].stats
        if cfg != replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE):
            raise AssertionError(f"train: not {LM_ARCH} at full width: {cfg}")
        if stats.steps_run != TRAIN_STEPS or not np.all(np.isfinite(stats.losses)):
            raise AssertionError(f"train: {stats.steps_run} steps, losses {stats.losses}")
        if ckpt.latest_step(args.ckpt_dir) is not None:
            raise AssertionError("train: the full-width run saved a checkpoint")
        step_s = float(np.median(stats.step_times[1:]))
        tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        state = out["loop"].state
        finite_tree("full-width state", state["params"])
        log("train", f"[{card}] {LM_ARCH} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, ssm_state {cfg.ssm_state}, vocab {cfg.vocab_size}, "
            f"{cfg.n_params() / 1e6:.2f} M parameters, {cfg.dtype}) through "
            f"train_lm, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: losses "
            f"{', '.join(f'{x:.4f}' for x in stats.losses)}; step wall (median of "
            f"steps 2-{TRAIN_STEPS}) {step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s "
            f"(steps {', '.join(f'{x * 1e3:.1f}' for x in stats.step_times)} ms); "
            f"peak device memory {peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} "
            f"GiB held before; train_lm {run_s:.1f} s in all (tokenizer, weights)")
        batch = out["batch_fn"](TRAIN_STEPS)
        (wall, acts), _, _ = device_window(lambda: out["step_fn"](state, batch))
        bound_ms, bound_by, flops, nbytes = train_step_bound(
            state, cfg, TRAIN_BATCH * TRAIN_SEQ)
        n_rec = sum(n for n, _ in acts.values())
        busy = sum(sec for _, sec in acts.values())
        log("train", f"[{card}] one more bf16 step under torch.profiler: wall "
            f"{wall * 1e3:.2f} ms, {n_rec} device records ({', '.join(f'{k} {n}' for k, (n, _) in acts.items())}), "
            f"device time {busy * 1e3:.3f} ms, busy {busy / wall:.2%}; bound "
            f"{bound_ms:.3f} ms by {bound_by} ({flops / 1e12:.3f} TFLOP at "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s: {flops / BF16_FLOPS_PER_S * 1e3:.3f} ms; "
            f"{nbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
        d_out, d_err = dry.communicate(timeout=TRAIN_CHILD_S)
        if dry.returncode != 0:
            raise AssertionError(f"train: the dry-run child exited {dry.returncode}: "
                                 f"{d_err[-2000:]}")
        d = json.loads(d_out.strip().splitlines()[-1])
        log("train", f"[{card}] the dry-run of the same step (repro_torch.launch.dryrun, "
            f"traced on meta tensors on the host, one rank of a (1, 1) mesh; counts, "
            f"not times): t_compute_s {d['t_compute_s'] * 1e3:.3f} ms ({d['flops'] / 1e12:.3f} "
            f"TFLOP of matmuls: the forward, remat's recompute and the backward) against "
            f"train_step_bound's {flops / BF16_FLOPS_PER_S * 1e3:.3f} ms by operations; "
            f"t_memory_s {d['t_memory_s'] * 1e3:.3f} ms ({d['bytes_accessed'] / 1e9:.3f} GB: "
            f"{d['ops']} eager ops' operands and results, views free, and "
            f"{d['argument_size_in_bytes'] / 1e9:.3f} GB of arguments) against its "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes; collectives "
            f"{d['collective_calls']} ({d['collective_bytes_total']} B); traced in "
            f"{d['trace_s']:.1f} s")
        # where its device time goes: one more step, kernels by device time
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out["step_fn"](state, batch)
            torch.cuda.synchronize()
        by_kernel = sorted(((e.key, e.device_time_total, e.count)
                            for e in prof.key_averages() if e.device_time_total > 0),
                           key=lambda r: -r[1])
        total_us = sum(t for _, t, _ in by_kernel)
        log("train", f"[{card}] that step's device time by kernel, {total_us / 1e3:.3f} "
            "ms in all; the eight largest: " + "; ".join(
                f"{name[:70]} {t / 1e3:.3f} ms ({n} calls)"
                for name, t, n in by_kernel[:8]))
        del out, state, batch
        torch.cuda.empty_cache()
        return {"losses": list(stats.losses), "step_s": step_s}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for proc in children:
            if proc.poll() is None:
                proc.kill()
            try:
                proc.communicate(timeout=30)
            except ValueError:  # its pipes were read and closed by a thread
                proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        log("train", f"the phase's wall {time.perf_counter() - t_phase:.1f} s")


def dist_phase(card: str, dev: torch.device, counts: PathCounts, trained: dict,
               fp32_card: dict | None = None, ranks: dict | None = None) -> None:
    """The distributed layer (``repro_torch.distributed``, ``launch.mesh``,
    ``train.mesh_step``) on a one-rank NCCL process group of the card
    (``tcp://localhost`` at a free port; no gloo fallback):

    (a) ``train_lm --mesh 1,1``: mamba2-780m at full width in bf16, batch
    ``TRAIN_BATCH`` x seq ``TRAIN_SEQ``, from the train phase's seed, its
    state placed as DTensors by ``state_shardings``: its first loss equal to
    the train phase's unsharded run's, the later ones within
    ``TRAIN_LATER_RTOL`` (``DIST_STEPS`` steps), its step wall beside the
    train phase's;
    (b) ``compressed_pmean`` over the ``"pod"`` dim of a (1,) mesh, on the
    gradient tree of one more batch of that state (803.35 M entries, bf16):
    the time a call (``DIST_COMPRESS_CALLS``, after one counted call) and
    the bytes it puts on the wire (the collective counter);
    (c) a smoke-width state trained one step at (1, 1) on the card, saved
    (every leaf gathered, rank 0 writes) and restored with ``shardings=``:
    equal leaves, DTensors again;
    then, the NCCL group destroyed, (d) ``DIST_SAMPLE_LEAVES`` of (b)'s
    leaves compressed again on a one-rank gloo group on the host: equal to
    the card's means and error feedback within one int8 step of the second
    scale (the elements that differ counted); (e) two ranks of a
    ``TP_MESH`` = (1, 2) mesh and four of a ``TP_MESH_DP`` = (2, 2) mesh on
    the one card (``--tp-rank`` children, started together by
    :func:`start_tp_ranks` before the train phase, or here when ``ranks``
    is None, each group meeting over gloo with CUDA tensors, since NCCL
    takes one rank a device), tensor-parallel over ``model``: the
    ``TP_SMOKE`` configs (among them attention on a rank's query heads and
    on its queries) and the ``TP_SMOKE_DP`` ones (MoE capacity slots split
    over ``data``, the token rows gathered and the partial outputs
    reduce-scattered, :func:`capacity_check`; a yi-9b widened to the FSDP threshold, its state placed
    with FSDP, :func:`fsdp_check`; ``TP_FSDP_FULL``, yi-9b at full width
    cut to 4 blocks with FSDP, :func:`fsdp_full_check`; ``TP_MOE_FULL``,
    mixtral-8x22b at full width with 3 experts and FSDP over 4,096 tokens,
    :func:`moe_full_check`; and ``TP_Q8`` and
    ``TP_Q8_FULL``, those two yi-9b with FSDP and 8-bit moments, each rank
    updating its own q8 rows, their train steps held step by step,
    :func:`q8_check`; and, at a batch of one, ``TP_SEQ_SPLIT`` and
    ``TP_SEQ_FULL``, whose KV caches' sequence splits over ``data``, each
    rank attending on its slice, :func:`seq_split_check`) in fp32 (TF32 off),
    the mesh prefill, ``TP_DECODE``
    decode steps and ``TP_TRAIN_STEPS`` train steps held to the card's
    one-device run within ``TP_TOL`` (:func:`tp_reference`), and mamba2-780m
    at full width in fp32 (48 SSM heads, 24 a rank) over the lm phase's
    prompt batch (``fp32_card``), prefill and ``LM_FP32_DECODE`` decode
    steps held to the lm phase's one-device card logits within ``LM_GATE``
    with equal greedy ids; each rank's parameter bytes and the matmul flops
    of one decode step beside the one-device run's; no leaf split over
    ``model`` gathered over it. No kernel of the port is on this path: the
    counts must stay 0. Every check raises."""
    from dataclasses import replace

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.compress import compressed_pmean, init_error_feedback
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.mesh import BACKENDS, free_port, process_group
    from repro_torch.launch.train import build_parser, train_lm
    from repro_torch.models.model import demo_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import full_tensor, make_mesh_train_step
    from repro_torch.train.state import make_abstract_state, make_state, state_shardings
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    sample: dict = {}
    ranks = ranks or start_tp_ranks(dev, fp32_card)
    tp_dir, procs = ranks["dir"], ranks["procs"]
    try:
        with process_group(dev):
            backend = tdist.get_backend()
            if backend != BACKENDS[dev.type] or tdist.get_world_size() != 1:
                raise AssertionError(f"dist: a {backend} group of "
                                     f"{tdist.get_world_size()} ranks")
            # ---- (a) train_lm --mesh 1,1 at full width
            args = build_parser().parse_args(
                ["--arch", LM_ARCH, "--steps", str(DIST_STEPS), "--batch",
                 str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every",
                 str(DIST_STEPS + 1), "--ckpt-dir", os.path.join(tmp, "full"),
                 "--mesh", "1,1"])
            torch.cuda.synchronize()
            counts.start()
            t0 = time.perf_counter()
            out = train_lm(args, dev, install_signals=False)
            run_s = time.perf_counter() - t0
            counts.end("dist", [])  # no kernel of the port on this path
            stats = out["loop"].stats
            state = out["loop"].state
            if out["mesh"] is None or tuple(out["mesh"].shape) != (1, 1):
                raise AssertionError("dist: train_lm did not train on a (1, 1) mesh")
            if not all(hasattr(t, "full_tensor") for t in leaves(state)):
                raise AssertionError("dist: the mesh state is not DTensors")
            want = trained["losses"][:DIST_STEPS]
            rel = [abs(g - w) / abs(w) for g, w in zip(stats.losses, want)]
            if len(rel) != DIST_STEPS or rel[0] > TRAIN_RESUME_RTOL or \
                    max(rel) > TRAIN_LATER_RTOL:
                raise AssertionError(f"dist: --mesh 1,1 losses {stats.losses} against "
                                     f"the unsharded run's {want}")
            step_s = float(np.median(stats.step_times[1:]))
            log("dist", f"[{card}] train_lm --mesh 1,1 ({LM_ARCH} at full width, bf16, "
                f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, the state as DTensors placed by "
                f"state_shardings): losses {', '.join(f'{x:.4f}' for x in stats.losses)} "
                f"against the train phase's unsharded {', '.join(f'{x:.4f}' for x in want)} "
                f"(relative {', '.join(f'{x:.2e}' for x in rel)}); step wall (median of "
                f"steps 2-{DIST_STEPS}) {step_s * 1e3:.2f} ms against the unsharded "
                f"{trained['step_s'] * 1e3:.2f} ms (steps "
                f"{', '.join(f'{x * 1e3:.1f}' for x in stats.step_times)} ms); "
                f"train_lm {run_s:.1f} s in all")

            # ---- (b) compressed_pmean over the full-width gradient tree
            full = tree_map(full_tensor, state["params"])
            batch = out["batch_fn"](DIST_STEPS)
            _, grads = loss_and_grads(full, batch, out["cfg"])
            del out, full, batch
            n_entries = sum(g.numel() for g in leaves(grads))
            pod = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
            ef = init_error_feedback(grads)
            with CollectiveCounter() as cc:
                mean, new_ef = compressed_pmean(grads, ef, pod, axis="pod")
            torch.cuda.synchronize()
            times = []
            for _ in range(DIST_COMPRESS_CALLS):
                t0 = time.perf_counter()
                compressed_pmean(grads, ef, pod, axis="pod")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            flat_g = dict(leaves_with_paths(grads))
            by_size = sorted(flat_g, key=lambda k: flat_g[k].numel())
            pick = [by_size[0], by_size[len(by_size) // 2],
                    max((k for k in by_size if flat_g[k].numel() <= 1 << 26),
                        key=lambda k: flat_g[k].numel())][:DIST_SAMPLE_LEAVES]
            flat_m, flat_e = dict(leaves_with_paths(mean)), dict(leaves_with_paths(new_ef))
            sample = {k: (flat_g[k].cpu(), flat_m[k].cpu(), flat_e[k].cpu()) for k in pick}
            finite = all(bool(torch.isfinite(m).all()) for m in leaves(mean))
            if not finite:
                raise AssertionError("dist: compressed_pmean's mean is not finite")
            wire = cc.total_bytes
            log("dist", f"[{card}] compressed_pmean on NCCL over the {LM_ARCH} gradient "
                f"tree ({n_entries / 1e6:.2f} M entries, {len(flat_g)} leaves, bf16): "
                f"{float(np.median(times)) * 1e3:.3f} ms a call (median of "
                f"{DIST_COMPRESS_CALLS}: {', '.join(f'{x * 1e3:.3f}' for x in times)} ms); "
                f"on the wire {wire} B ({wire / n_entries:.4f} B an entry: "
                + ", ".join(f"{k} {cc.calls[k]} x {cc.bytes[k]} B" for k in sorted(cc.calls))
                + ")")
            del grads, ef, mean, new_ef, state
            torch.cuda.empty_cache()

            # ---- (c) a checkpoint on the (1, 1) mesh, restored with shardings=
            cfg_s = replace(REGISTRY[LM_ARCH].smoke(), vocab_size=VOCAB_SIZE)
            opt = AdamWConfig()
            mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
            abstract = make_abstract_state(cfg_s, opt)
            sh = state_shardings(abstract, mesh, cfg_s)
            st = place_tree(make_state(cfg_s, opt, seed=0, device=dev), sh)
            st, _ = make_mesh_train_step(cfg_s, opt, mesh, sh)(
                st, demo_batch(cfg_s, 2, 32, device=dev))
            d = ckpt.save(st, 1, os.path.join(tmp, "mesh"))
            back, s_back = ckpt.restore(os.path.dirname(d), abstract, device=dev,
                                        shardings=sh)
            same = all(hasattr(b, "full_tensor") and torch.equal(b.full_tensor(), a.full_tensor())
                       for b, a in zip(leaves(back), leaves(st)))
            if s_back != 1 or not same:
                raise AssertionError("dist: the (1, 1) checkpoint restores differently")
            log("dist", f"[{card}] a {cfg_s.name} smoke state trained one step at (1, 1), "
                f"saved ({len(leaves(st))} leaves gathered, rank 0 writes) and restored "
                f"with shardings=: DTensors equal to the saved state")
            del st, back
        # ---- (d) the sampled leaves on gloo on the host, the group destroyed
        t0 = time.perf_counter()
        tdist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                                 rank=0, world_size=1)
        try:
            host_pod = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
            g_tree = {k.replace("/", "."): v[0] for k, v in sample.items()}
            h_mean, h_ef = compressed_pmean(g_tree, init_error_feedback(g_tree), host_pod)
        finally:
            tdist.destroy_process_group()
        differ, steps = 0, []
        for k, (g, m_card, e_card) in sample.items():
            hk = k.replace("/", ".")
            scale2 = float(h_mean[hk].abs().max()) / 127.0 + 1e-30
            d_m = (m_card.float() - h_mean[hk]).abs()
            d_e = (e_card.float() - h_ef[hk]).abs()
            if float(d_m.max()) > scale2 * (1 + 1e-6) or float(d_e.max()) > scale2:
                raise AssertionError(f"dist: compressed_pmean of {k} on the card and on "
                                     f"the host differ by {float(d_m.max())} (step {scale2})")
            differ += int((d_m > 0).sum()) + int((d_e > 0).sum())
            steps.append(f"{k} ({g.numel()} entries)")
        log("dist", f"[{card}] the same call on gloo on the host over {len(sample)} of its "
            f"leaves ({', '.join(steps)}): the mean and the error feedback within one "
            f"int8 step of the second scale of the card's; elements that differ at all: "
            f"{differ}; {time.perf_counter() - t0:.1f} s")

        # ---- (e) the tensor-parallel ranks against the one-device run
        t0 = time.perf_counter()
        counts.start()
        want = tp_reference(dev, fp32_card["max_seq"] if fp32_card else TP_SEQ)
        counts.end("dist", [])  # the one-device runs launch no kernel of the port
        ref_s = time.perf_counter() - t0
        deadline = ranks["t0"] + TP_CHILD_S
        for mesh, out_dir, which in ranks["groups"]:
            for r, i in enumerate(which):
                try:
                    procs[i].wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"dist: tensor-parallel rank {r} of {mesh} still "
                                         f"running after {TP_CHILD_S} s") from None
            ranks_s = max(ranks["ended"].get(i, time.perf_counter()) for i in which) \
                - ranks["t0"]
            for r, i in enumerate(which):
                if procs[i].returncode != 0:
                    with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                        tail = f.read()[-3000:]
                    raise AssertionError(f"dist: tensor-parallel rank {r} of {mesh} exited "
                                         f"{procs[i].returncode}: {tail}")
            got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(len(which))]
            tp_check(card, mesh, got, want, fp32_card if mesh == TP_MESH else None,
                     ref_s, ranks_s)
            if mesh == TP_MESH_DP:
                for name in (TP_Q8[0], TP_Q8_FULL):
                    q8_check(card, dev, mesh, got, name, out_dir)
                seq_split_check(card, mesh, got, want)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tp_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    log("dist", f"the phase's wall {time.perf_counter() - t_phase:.1f} s")


def start_tp_ranks(dev: torch.device, fp32_card: dict | None) -> dict:
    """Start the dist phase's tensor-parallel ranks together, the
    ``TP_MESH`` group's and the ``TP_MESH_DP`` group's (``chip_smoke.py
    --tp-rank``, a gloo group each at its own port, output to a log each),
    with the lm phase's prompt batch and ids (``fp32_card``) saved for the
    ``TP_MESH`` ranks; killed at exit if still running. Returns the
    directory (a subdirectory a group), the processes and their start time,
    and a map that a watcher thread fills with each one's end time."""
    import atexit

    from repro_torch.launch.mesh import free_port

    tp_dir = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    t0 = time.perf_counter()
    procs, groups = [], []
    for mesh in (TP_MESH, TP_MESH_DP):
        out = os.path.join(tp_dir, "x".join(map(str, mesh)))
        os.makedirs(out)
        if fp32_card is not None and mesh == TP_MESH:
            torch.save({k: fp32_card[k] for k in ("tokens", "ids", "max_seq")},
                       os.path.join(out, "inputs.pt"))
        port = free_port()
        first = len(procs)
        for r in range(mesh[0] * mesh[1]):
            with open(os.path.join(out, f"rank{r}.log"), "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                     str(port), out, dev.type, f"{mesh[0]},{mesh[1]}"], stdout=f,
                    stderr=subprocess.STDOUT,
                    env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}))
        groups.append((mesh, out, list(range(first, len(procs)))))
    ended: dict = {}

    def watch():
        for r, proc in enumerate(procs):
            proc.wait()
            ended[r] = time.perf_counter()

    threading.Thread(target=watch, daemon=True).start()
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"dir": tp_dir, "groups": groups, "procs": procs, "t0": t0, "ended": ended}


def _tp_at(rank: int, mesh: tuple) -> dict:
    """The (data, model) coordinates of global rank ``rank`` of a
    ``(data, model)`` mesh (row-major, as ``init_device_mesh`` lays it)."""
    return {"data": rank // mesh[1], "model": rank % mesh[1]}


def _tp_cut(t: torch.Tensor, spec: tuple, at: dict, mesh: tuple) -> torch.Tensor:
    """The part of ``t`` that the rank at coordinates ``at`` of a ``(data,
    model)`` ``mesh`` holds under ``spec`` (a dim over several axes split
    data-major)."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    for d, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,)) if a]
        if axes:
            n, i = 1, 0
            for a in axes:
                n, i = n * sizes[a], i * sizes[a] + at[a]
            t = t.chunk(n, d)[i]
    return t


def _tp_cases(mesh: tuple) -> dict:
    """The smoke configs the ranks of ``mesh`` run."""
    return TP_SMOKE if tuple(mesh) == TP_MESH else TP_SMOKE_DP


def _tp_cfg(name: str):
    from dataclasses import replace

    from repro_torch.configs import REGISTRY

    arch, changes = {**TP_SMOKE, **TP_SMOKE_DP}[name]
    return replace(REGISTRY[arch].smoke(), dtype="float32", **changes)


def _tp_full_cfg():
    """The ``TP_FSDP_FULL`` config: its architecture at full width in fp32,
    cut in depth to its blocks."""
    from dataclasses import replace

    from repro_torch.configs import REGISTRY

    _, arch, blocks = TP_FSDP_FULL
    cfg = REGISTRY[arch]
    return replace(cfg, n_layers=blocks * cfg.layers_per_block, dtype="float32")


def _moe_full_cfg():
    """The ``TP_MOE_FULL`` config: its architecture at full width with 3
    experts (which do not divide over ``model``) in fp32, cut in depth."""
    from dataclasses import replace

    from repro_torch.configs import REGISTRY

    _, arch, layers = TP_MOE_FULL
    return replace(REGISTRY[arch], n_layers=layers, n_experts=3, dtype="float32")


def _tp_full_params(cfg, dev: torch.device) -> dict:
    """Its parameters drawn on the card from the card's generator at seed 0:
    the same weights in every process on the card, in seconds where the
    host's generator takes minutes at this width."""
    from repro_torch.models.transformer import init_params

    with torch.device(dev):
        return init_params(torch.Generator(device=dev).manual_seed(0), cfg)


def tp_reference(dev: torch.device, max_seq: int) -> dict:
    """The one-device card run (fp32, TF32 off) that the dist phase's
    tensor-parallel ranks are held to: for each ``TP_SMOKE`` and
    ``TP_SMOKE_DP`` config, the
    prefill and decode logits, the train steps' losses and state (on the
    host), each parameter's allowance (lr x the change of each step for a
    gradient change of ``TP_TOL`` of the leaf's largest gradient: Adam
    divides every entry by its own magnitude, as the CPU tests allow) and
    the state's shardings on its ranks' mesh; under ``"seq"`` the batch-1
    cases' (:func:`seq_reference`); for ``TP_FSDP_FULL`` and
    ``TP_MOE_FULL`` (on the card's generator, :func:`_tp_full_params`) the
    logits, the losses and the shardings; and, on ``meta`` tensors,
    mamba2-780m's full-width fp32 parameter bytes and the matmul flops of
    one decode step of the lm phase's prompt batch (5 rows, a cache of
    ``max_seq``)."""
    from dataclasses import replace

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.models.model import demo_batch, serve_decode, serve_prefill
    from repro_torch.models.transformer import abstract_cache, abstract_params
    from repro_torch.optim.adamw import (AdamWConfig, cosine_schedule, init_state,
                                         param_nodes)
    from repro_torch.train.state import make_abstract_state, make_state, state_shardings
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    try:
        for mesh, name in [(m, n) for m in (TP_MESH, TP_MESH_DP) for n in _tp_cases(m)]:
            cfg = _tp_cfg(name)
            opt = AdamWConfig()
            state = make_state(cfg, opt, seed=0, device=dev)
            state["step"].fill_(50)
            with torch.no_grad():
                logits, cache = serve_prefill(
                    state["params"], demo_batch(cfg, TP_BATCH, TP_SEQ, kind="prefill",
                                                seed=1, device=dev),
                    cfg, max_seq=TP_SEQ + TP_DECODE)
                steps = []
                for i in range(TP_DECODE):
                    tok = demo_batch(cfg, TP_BATCH, 1, kind="decode", seed=2 + i, device=dev)
                    lg, cache = serve_decode(state["params"], cache, tok, cfg)
                    steps.append(lg.cpu())
            step = make_train_step(cfg, opt)
            losses, allowance = [], None
            for i in range(TP_TRAIN_STEPS):
                batch = demo_batch(cfg, TP_BATCH, TP_SEQ, kind="train", seed=i, device=dev)
                _, grads = loss_and_grads(state["params"], batch, cfg)
                norm = sum(float(g.double().square().sum()) for g in leaves(grads)) ** 0.5
                clip = min(1.0, opt.grad_clip / (norm + 1e-9))
                count = int(state["opt"]["count"]) + 1
                bc1, bc2 = 1 - opt.b1 ** count, 1 - opt.b2 ** count
                lr = opt.lr * float(cosine_schedule(state["step"]))
                nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"],
                                    grads)
                more = {}
                for (path, _), (_, m, v, g) in zip(leaves_with_paths(state["params"]), nodes):
                    g, m, v = g.double() * clip, m.double(), v.double()

                    def adam(x, m=m, v=v):
                        mf = opt.b1 * m + (1 - opt.b1) * x
                        vf = opt.b2 * v + (1 - opt.b2) * x * x
                        return (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)

                    d = TP_TOL * float(g.abs().max())
                    more[path] = (lr * torch.maximum((adam(g + d) - adam(g)).abs(),
                                                     (adam(g - d) - adam(g)).abs())).cpu()
                allowance = more if allowance is None else \
                    {k: allowance[k] + more[k] for k in more}
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            out[name] = {"logits": logits.cpu(), "steps": steps, "losses": losses,
                         "state": tree_map(lambda t: t.cpu(), state),
                         "allowance": allowance,
                         "shardings": state_shardings(make_abstract_state(cfg, opt),
                                                      {"data": mesh[0], "model": mesh[1]},
                                                      cfg, fsdp=name in TP_FSDP)}
        out["seq"] = seq_reference(dev)
        # the full-width FSDP cases: logits and losses only (their state is
        # held leaf by leaf at smoke width)
        for name, cfg, seq in [(TP_FSDP_FULL[0], _tp_full_cfg(), TP_SEQ),
                               (TP_MOE_FULL[0], _moe_full_cfg(), TP_MOE_SEQ)]:
            opt = AdamWConfig()
            params = _tp_full_params(cfg, dev)
            state = {"params": params, "opt": init_state(params, opt),
                     "step": torch.full((), 50, dtype=torch.int32, device=dev)}
            with torch.no_grad():
                logits, cache = serve_prefill(
                    params, demo_batch(cfg, TP_BATCH, seq, kind="prefill", seed=1,
                                       device=dev), cfg, max_seq=seq + TP_DECODE)
                steps = []
                for i in range(TP_DECODE):
                    tok = demo_batch(cfg, TP_BATCH, 1, kind="decode", seed=2 + i, device=dev)
                    lg, cache = serve_decode(params, cache, tok, cfg)
                    steps.append(lg.cpu())
            del params, cache
            step = make_train_step(cfg, opt)
            losses = []
            for i in range(TP_TRAIN_STEPS):
                state, metrics = step(state, demo_batch(cfg, TP_BATCH, seq, kind="train",
                                                        seed=i, device=dev))
                losses.append(float(metrics["loss"]))
            out[name] = {
                "logits": logits.cpu(), "steps": steps, "losses": losses,
                "shardings": state_shardings(make_abstract_state(cfg, opt),
                                             {"data": TP_MESH_DP[0], "model": TP_MESH_DP[1]},
                                             cfg, fsdp=True)}
            del state, step, logits
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    cfg32 = replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE, dtype="float32")
    aparams = abstract_params(cfg32)
    with FlopCounterMode(display=False) as fc:
        serve_decode(aparams, abstract_cache(cfg32, 5, max_seq),
                     {"token": torch.empty((5, 1), dtype=torch.int32, device="meta")},
                     cfg32)
    out["full"] = {"param_bytes": sum(t.numel() * t.element_size() for t in leaves(aparams)),
                   "decode_flops": int(fc.get_total_flops())}
    return out


def _seq_cfg(name: str):
    """A ``TP_SEQ_SPLIT`` smoke config in fp32, or ``TP_SEQ_FULL``'s
    architecture at full width in fp32 cut in depth to its layers."""
    from dataclasses import replace

    from repro_torch.configs import REGISTRY

    if name == TP_SEQ_FULL[0]:
        cfg = REGISTRY[TP_SEQ_FULL[1]]
        return replace(cfg, n_layers=TP_SEQ_FULL[2], dtype="float32")
    return replace(REGISTRY[name].smoke(), dtype="float32")


def _seq_cases(dev) -> list:
    """The batch-1 cases: ``(name, cfg, parameters on dev, prompt, slots,
    steps)``, the smoke configs' from seed 0 on the host's generator, the
    full-width one's on the card's (:func:`_tp_full_params`)."""
    from repro_torch.models.model import build_params

    out = [(n, _seq_cfg(n), lambda n=n: build_params(_seq_cfg(n), seed=0, device=dev),
            TP_SEQ_PROMPT, TP_SEQ_MAX, TP_SEQ_STEPS) for n in TP_SEQ_SPLIT]
    full = _seq_cfg(TP_SEQ_FULL[0])
    return out + [(TP_SEQ_FULL[0], full, lambda: _tp_full_params(full, dev),
                   TP_SEQ_FULL_PROMPT, TP_SEQ_FULL_MAX, TP_SEQ_FULL_STEPS)]


def seq_reference(dev) -> dict:
    """The batch-1 cases on one device: the prefill's logits and each
    decode step's, by case."""
    from repro_torch.models.model import demo_batch, serve_decode, serve_prefill

    out = {}
    with torch.no_grad():
        for name, cfg, params, prompt, slots, steps in _seq_cases(dev):
            params = params()
            logits, cache = serve_prefill(params, demo_batch(cfg, 1, prompt, kind="prefill",
                                                             seed=1, device=dev),
                                          cfg, max_seq=slots)
            got = [logits.cpu()]
            for i in range(steps):
                lg, cache = serve_decode(params, cache, demo_batch(cfg, 1, 1, kind="decode",
                                                                   seed=2 + i, device=dev), cfg)
                got.append(lg.cpu())
            out[name] = got
            del params, cache
    return out


def seq_split_rank(mesh, dev, place, data_group: str) -> dict:
    """On a rank of ``mesh``: each batch-1 case's parameters placed by
    ``param_shardings`` (``place`` cuts the rank's shards), its mesh
    prefill and decode steps, the latter under the collective counter.
    Returns, by case, the logits (the prefill's, then each step's), the
    decode steps' all-gathers and all-reduces over ``data``
    (``data_group``'s name), and each cache leaf's global and local shape
    and whether its sequence is split, after the steps."""
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models.model import demo_batch
    from repro_torch.train.mesh_step import (_seq_split, local, make_mesh_decode_step,
                                             make_mesh_prefill_step)
    from repro_torch.tree import leaves_with_paths

    out = {}
    for name, cfg, params, prompt, slots, steps in _seq_cases(dev):
        t0 = time.perf_counter()
        params = params()
        placed = place(params, param_shardings(params, mesh, cfg))
        del params
        logits, cache = make_mesh_prefill_step(cfg, mesh, max_seq=slots)(
            placed, demo_batch(cfg, 1, prompt, kind="prefill", seed=1, device=dev))
        got = [logits.cpu()]
        decode = make_mesh_decode_step(cfg, mesh)
        with CollectiveCounter() as cc:
            for i in range(steps):
                lg, cache = decode(placed, cache, demo_batch(cfg, 1, 1, kind="decode",
                                                             seed=2 + i, device=dev))
                got.append(lg.cpu())
        split = _seq_split(mesh, cache)
        out[name] = {"logits": got,
                     "data_gathers": cc.by_group[data_group, "all-gather"],
                     "data_reduces": cc.by_group[data_group, "all-reduce"],
                     "leaves": {p: (tuple(t.shape), tuple(local(t).shape),
                                    p.split("/")[-1] in split.get(p.split("/")[1], ()))
                                for p, t in leaves_with_paths(cache["blocks"], "blocks")},
                     "s": round(time.perf_counter() - t0, 1)}
        del placed, cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def seq_split_check(card: str, mesh: tuple, got: list, want: dict) -> None:
    """The batch-1 cases on each rank of ``mesh`` (:func:`seq_split_rank`)
    against the one-device card run (``want["seq"]``, :func:`seq_reference`): the smoke
    configs' logits within ``TP_TOL`` of the largest, the full-width
    case's within ``LM_GATE`` with equal greedy ids; no all-gather over
    ``data`` in the decode steps, and three all-reduces over it for each
    split attention sublayer a step; each split leaf S/d slots a rank
    after them, the others whole. Every check raises."""
    d = mesh[0]
    worst, lines = {}, []
    for name in (*TP_SEQ_SPLIT, TP_SEQ_FULL[0]):
        tol = LM_GATE if name == TP_SEQ_FULL[0] else TP_TOL
        errs = []
        for r, rank in enumerate(got):
            g = rank["seq"][name]
            for i, (a, b) in enumerate(zip(g["logits"], want["seq"][name], strict=True)):
                errs.append(float((a.double() - b.double()).abs().max()
                                  / b.double().abs().max()))
                if a.shape != b.shape or errs[-1] > tol or \
                        (tol == LM_GATE and not torch.equal(a.argmax(-1), b.argmax(-1))):
                    raise AssertionError(f"dist: {name} batch 1 rank {r} "
                                         f"{'prefill' if i == 0 else f'decode {i}'} logits "
                                         f"differ from the one-device run by {errs[-1]:.3e} "
                                         f"(bound {tol}), or their ids")
            # three all-reduces a split attention sublayer (self "k", cross "xk")
            sub = sum(s for p, (_, _, s) in g["leaves"].items()
                      if p.rsplit("/", 1)[-1] in ("k", "xk"))
            steps = TP_SEQ_FULL_STEPS if name == TP_SEQ_FULL[0] else TP_SEQ_STEPS
            if g["data_gathers"] or \
                    g["data_reduces"] != 3 * sub * _seq_cfg(name).n_blocks * steps:
                raise AssertionError(f"dist: {name} batch 1 rank {r}: {g['data_gathers']} "
                                     f"all-gathers and {g['data_reduces']} all-reduces over "
                                     f"data in the decode steps, not 0 and 3 x {sub} split "
                                     f"sublayers a block x {steps} steps")
            for path, (whole, mine, split) in g["leaves"].items():
                kv = path.rsplit("/", 1)[-1] in ("k", "v", "xk", "xv")
                if (split and (whole[2] % d or mine[2] != whole[2] // d)) or \
                        (kv and not split and mine[2] != whole[2]):
                    raise AssertionError(f"dist: {name} rank {r} cache {path} {mine} of "
                                         f"{whole} after the steps (split {split})")
        g = got[0]["seq"][name]
        split = sorted(f"{p} ({w[2]} -> {m[2]})" for p, (w, m, s) in g["leaves"].items()
                       if s and p.rsplit("/", 1)[-1] in ("k", "xk"))
        worst[name] = max(errs)
        lines.append(f"{name}: worst {max(errs):.2e}, split {', '.join(split) or 'none'}, "
                     f"all-reduces over data a rank {g['data_reduces']}, "
                     f"{', '.join(str(x['seq'][name]['s']) for x in got)} s")
    cfg = _seq_cfg(TP_SEQ_FULL[0])
    log("dist", f"[{card}] (e) batch 1 on the {mesh} ranks: the KV caches' sequence split "
        f"over data where it divides, attended on a rank's slice with the softmax combined "
        f"over data (no all-gather over data in the decode steps, 3 all-reduces over it "
        f"a split attention sublayer a step; each split leaf S/d slots a rank after "
        f"them); smoke configs: a {TP_SEQ_PROMPT}-token prompt into "
        f"{TP_SEQ_MAX} slots, {TP_SEQ_STEPS} decode steps, within {TP_TOL} of the card's "
        f"one-device run; {TP_SEQ_FULL[0]}: {cfg.name} at full width (d_model "
        f"{cfg.d_model}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads, vocab "
        f"{cfg.vocab_size}) in fp32, {cfg.n_layers} layers, a {TP_SEQ_FULL_PROMPT}-token "
        f"prompt into {TP_SEQ_FULL_MAX} slots, {TP_SEQ_FULL_STEPS} decode steps, within "
        f"{LM_GATE} with equal greedy ids; " + "; ".join(lines))


def tp_check(card: str, mesh: tuple, got: list, want: dict, fp32_card: dict | None,
             ref_s: float, ranks_s: float) -> None:
    """Hold each tensor-parallel rank of ``mesh`` (its results from
    :func:`tp_rank`) to the one-device run's (:func:`tp_reference`, and the
    lm phase's full-width card logits): its prefill logits to its data
    share's rows, the decode logits, the losses and its shard of every
    leaf of the state; log them. Every check raises."""
    from repro_torch.tree import leaves_with_paths

    m = mesh[1]
    rows = TP_BATCH // mesh[0]

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    worst, calls = {}, 0
    for name in _tp_cases(mesh):
        w = want[name]
        errs = []
        for r, rank in enumerate(got):
            at = _tp_at(r, mesh)
            g = rank["smoke"][name]
            if g["bad"]:
                raise AssertionError(f"dist: rank {r} gathered model-sharded leaves of "
                                     f"{name} over model: {g['bad'][:3]}")
            calls += g["model_calls"]
            share = w["logits"][at["data"] * rows:(at["data"] + 1) * rows]
            for what, a, b in [("prefill", g["logits"], share)] + [
                    (f"decode {i + 1}", x, y) for i, (x, y) in enumerate(zip(g["steps"],
                                                                           w["steps"]))]:
                errs.append(rel(a, b))
                if a.shape != b.shape or errs[-1] > TP_TOL:
                    raise AssertionError(f"dist: {name} rank {r} {what} logits differ from "
                                         f"the one-device run by {errs[-1]:.3e}")
            for a, b in zip(g["losses"], w["losses"]):
                if abs(a - b) > TP_TOL * abs(b):
                    raise AssertionError(f"dist: {name} rank {r} losses {g['losses']} "
                                         f"against {w['losses']}")
            specs = dict(leaves_with_paths(w["shardings"]))
            mine = dict(leaves_with_paths(g["state"]))
            allow = w["allowance"]
            for path, whole in leaves_with_paths(w["state"]):
                part = _tp_cut(whole, specs[path].spec, at, mesh)
                a = mine[path]
                if a.shape != part.shape or a.dtype != part.dtype:
                    raise AssertionError(f"dist: {name} rank {r} {path}: {tuple(a.shape)} "
                                         f"{a.dtype}, not {tuple(part.shape)} {part.dtype}")
                diff = (a.double() - part.double()).abs()
                key = path.removeprefix("params/")
                if path.startswith("params/"):
                    diff = diff - _tp_cut(allow[key], specs[path].spec, at, mesh) * (1 + 1e-6)
                bound = TP_TOL * max(float(whole.double().abs().max()), 1e-30)
                if float(diff.max()) > bound:
                    raise AssertionError(f"dist: {name} rank {r} {path} after "
                                         f"{TP_TRAIN_STEPS} steps: {float(diff.max()):.3e} "
                                         f"> {bound:.3e}")
        worst[name] = max(errs)
    # the capacity split's own signature, recorded by each rank
    split = "; ".join(capacity_check(mesh, n, _tp_cfg(n), TP_SEQ,
                                     [rank["smoke"][n] for rank in got])
                      for n in _tp_cases(mesh) if n not in TP_FSDP) \
        if tuple(mesh) == TP_MESH_DP else ""
    for name in TP_FSDP & set(_tp_cases(mesh)):
        fsdp_check(card, mesh, name, _tp_cfg(name), want[name]["shardings"],
                   [rank["smoke"][name] for rank in got])
    if tuple(mesh) == TP_MESH_DP:
        fsdp_full_check(card, mesh, got, want[TP_FSDP_FULL[0]])
        moe_full_check(card, mesh, got, want[TP_MOE_FULL[0]])
    log("dist", f"[{card}] (e) {len(got)} ranks of a {mesh} mesh on the card, tensor-parallel "
        f"over model, meeting over gloo with CUDA tensors; {len(_tp_cases(mesh))} smoke configs "
        f"in fp32 (TF32 off): prefill ({TP_BATCH}, {TP_SEQ}), {TP_DECODE} decode steps and "
        f"{TP_TRAIN_STEPS} train steps from step 50 == the card's one-device run within "
        f"{TP_TOL} (logits per rank, the losses, and every parameter and moment shard, "
        f"beyond each step's Adam allowance); worst logit error per arch: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; no model-sharded leaf gathered over model; {calls} collectives over model "
        f"in all{f'; the MoE capacity split over data: {split}' if split else ''}"
        f"; the one-device runs {ref_s:.1f} s, the ranks {ranks_s:.1f} s from their "
        f"start (each: {', '.join(str(x['times']) for x in got)})")
    if fp32_card is None:
        return
    full = want["full"]
    errs, same = [], []
    for r, rank in enumerate(got):
        f = rank["full"]
        if f["bad"]:
            raise AssertionError(f"dist: rank {r} gathered model-sharded leaves of "
                                 f"{LM_ARCH} over model: {f['bad'][:3]}")
        for i, (a, b) in enumerate(zip(f["logits"], fp32_card["logits"], strict=True)):
            errs.append(rel(a, b))
            same.append(bool(torch.equal(a.argmax(-1), b.argmax(-1))))
            if errs[-1] > LM_GATE or not same[-1]:
                raise AssertionError(f"dist: {LM_ARCH} at full width rank {r} call {i}: "
                                     f"{errs[-1]:.3e} from the one-device card run (gate "
                                     f"{LM_GATE}), greedy ids equal {same[-1]}")
    heads = got[0]["full"]["heads"]
    log("dist", f"[{card}] (e) {LM_ARCH} at full width in fp32 on the two ranks "
        f"({heads * m} SSM heads, {heads} a rank; vocab {got[0]['full']['vocab']}, "
        f"embedding split by {got[0]['full']['embed']}), the lm phase's "
        f"{tuple(fp32_card['tokens'].shape)} prompt batch, prefill + {LM_FP32_DECODE} decode "
        f"steps: max abs err / max |logit| against the lm phase's one-device card run "
        f"{max(errs):.3e} (gate {LM_GATE}); greedy ids equal {all(same)}; parameter bytes a "
        f"rank {', '.join(str(x['full']['param_bytes']) for x in got)} against "
        f"{full['param_bytes']} on one device; matmul flops of one decode step "
        f"(FlopCounterMode) a rank {', '.join(str(x['full']['decode_flops']) for x in got)} "
        f"against {full['decode_flops']} on one device; "
        f"{sum(x['full']['model_calls'] for x in got)} collectives over model")


def fsdp_check(card: str, mesh: tuple, name: str, cfg, shardings: dict,
               got: list) -> None:
    """An FSDP case (each rank's results ``got``): its all-gathers over
    ``data`` on each rank, a block's FSDP leaves gathered where the block
    runs (once in the prefill and in each decode step, which also gathers
    its logits; twice a train step, the forward pass and remat's
    recompute) and the others' once a call, none of a block's at a step's
    start; and each rank's peak device memory over the train steps below
    that of a pass that gathers every leaf at its start, by at least
    (blocks - 2) blocks' gathered FSDP bytes (:func:`fsdp_memory`). Every
    check raises."""
    from repro_torch.tree import leaves_with_paths

    on_data = [p for p, s in leaves_with_paths(shardings["params"])
               if s.placements()[0].is_shard()]  # mesh dims (data, model)
    fsdp = [p for p in on_data if p.startswith("blocks/")]
    if not fsdp:
        raise AssertionError(f"dist: no block leaf of {name} is FSDP-sharded at {mesh}")
    blocks, outer = len(fsdp) * cfg.n_blocks, len(on_data) - len(fsdp)
    expect = [(blocks + outer) * (1 + TP_DECODE) + TP_DECODE,
              (2 * blocks + outer) * TP_TRAIN_STEPS]
    counts = [g["data_gathers"] for g in got]
    if any(c != expect for c in counts):
        raise AssertionError(f"dist: {name} ranks made {counts} all-gathers over data "
                             f"(serve, train), not {expect}")
    mem = [g["memory"] for g in got]
    need = max(cfg.n_blocks - 2, 0)
    for r, m in enumerate(mem):
        if m["step"] is not None and m["whole"] - m["step"] < need * m["block_bytes"]:
            raise AssertionError(
                f"dist: {name} rank {r} peaked at {m['step']} B over its train steps, "
                f"{m['whole'] - m['step']} B below a pass gathering the whole tree "
                f"({m['whole']} B), not the {need} x {m['block_bytes']} B of "
                f"{need} blocks' gathered FSDP leaves")
    log("dist", f"[{card}] (e) {name} at {mesh} with FSDP ({len(fsdp)} block leaves and "
        f"{outer} others sharded over data, {cfg.n_blocks} blocks): all-gathers over data "
        f"a rank (CollectiveCounter.by_group) {expect[0]} in the prefill and {TP_DECODE} "
        f"decode steps, {expect[1]} in {TP_TRAIN_STEPS} train steps, as expected; "
        f"max_memory_allocated a rank over the train steps "
        f"{', '.join(str(m['step']) for m in mem)} B, after them "
        f"{', '.join(str(m['state']) for m in mem)} B; a pass gathering every leaf at its "
        f"start {', '.join(str(m['whole']) for m in mem)} B; saved "
        f"{', '.join(str(m['whole'] - m['step']) for m in mem if m['step'] is not None)} B "
        f"against {need} x {mem[0]['block_bytes']} B (a block's FSDP leaves gathered)")


def _full_case(name: str, mesh: tuple, got: list, want: dict, ids: bool) -> float:
    """A full-width case ``name`` on each rank of ``mesh``: its prefill
    logits (the rank's data rows), decode logits and losses within
    ``TP_TOL`` of the card's one-device run (with ``ids``, equal greedy
    ids too), and no leaf split over ``model`` gathered over it. Raises;
    returns the worst logit error."""
    rows = TP_BATCH // mesh[0]
    errs = []
    for r, rank in enumerate(got):
        g, at = rank[name], _tp_at(r, mesh)
        if g["bad"]:
            raise AssertionError(f"dist: rank {r} gathered model-sharded leaves of "
                                 f"{name} over model: {g['bad'][:3]}")
        share = want["logits"][at["data"] * rows:(at["data"] + 1) * rows]
        for what, a, b in [("prefill", g["logits"], share)] + [
                (f"decode {i + 1}", x, y) for i, (x, y) in enumerate(zip(g["steps"],
                                                                       want["steps"],
                                                                       strict=True))]:
            errs.append(float((a.double() - b.double()).abs().max()
                              / b.double().abs().max()))
            if a.shape != b.shape or errs[-1] > TP_TOL or \
                    (ids and not torch.equal(a.argmax(-1), b.argmax(-1))):
                raise AssertionError(f"dist: {name} rank {r} {what} logits differ from the "
                                     f"one-device run by {errs[-1]:.3e}, or their ids")
        for a, b in zip(g["losses"], want["losses"], strict=True):
            if abs(a - b) > TP_TOL * abs(b):
                raise AssertionError(f"dist: {name} rank {r} losses {g['losses']} "
                                     f"against {want['losses']}")
    return max(errs)


def fsdp_full_check(card: str, mesh: tuple, got: list, want: dict) -> None:
    """The ``TP_FSDP_FULL`` case on each rank of ``mesh``: :func:`_full_case`
    with equal greedy ids, then :func:`fsdp_check`. Every check raises."""
    name = TP_FSDP_FULL[0]
    worst = _full_case(name, mesh, got, want, ids=True)
    cfg = _tp_full_cfg()
    log("dist", f"[{card}] (e) {name}: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads, vocab "
        f"{cfg.vocab_size}) in fp32, {cfg.n_blocks} blocks, on the {mesh} ranks with FSDP: "
        f"prefill, {TP_DECODE} decode steps and losses {got[0][name]['losses']} == the "
        f"card's one-device run's {want['losses']} within {TP_TOL} (worst logit error "
        f"{worst:.2e}, greedy ids equal)")
    fsdp_check(card, mesh, name, cfg, want["shardings"], [rank[name] for rank in got])


def moe_full_check(card: str, mesh: tuple, got: list, want: dict) -> None:
    """The ``TP_MOE_FULL`` case on each rank of ``mesh``: :func:`_full_case`
    (4,096 prefill rows: a greedy id may tie within the bound, so ids are
    not asked), then :func:`capacity_check`. Every check raises."""
    name = TP_MOE_FULL[0]
    worst = _full_case(name, mesh, got, want, ids=False)
    cfg = _moe_full_cfg()
    split = capacity_check(mesh, name, cfg, TP_MOE_SEQ, [rank[name] for rank in got])
    log("dist", f"[{card}] (e) {name}: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads, vocab "
        f"{cfg.vocab_size}) with {cfg.n_experts} experts (top-{cfg.top_k}) in fp32, "
        f"cut to {cfg.n_layers} layer, on the {mesh} ranks with FSDP: prefill ({TP_BATCH}, "
        f"{TP_MOE_SEQ}), {TP_DECODE} decode steps and losses {got[0][name]['losses']} == "
        f"the card's one-device run's {want['losses']} within {TP_TOL} (worst logit error "
        f"{worst:.2e}); the capacity split over data: {split}; the case "
        f"{', '.join(str(x['times']['moe_full_s']) for x in got)} s of a rank")


def _q8_case(name: str, dev, zeros: bool = False) -> tuple:
    """A q8 case's config, optimizer and initial state on ``dev`` at step
    50: ``TP_Q8``'s smoke config from seed 0, or ``TP_Q8_FULL``'s full
    width with :func:`_tp_full_params` (its moments ``meta`` where
    ``zeros``: :func:`tp_rank`'s ``place`` makes them the zeros
    ``init_state`` makes)."""
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.state import make_abstract_state, make_state

    opt = AdamWConfig(quantized_moments=True)
    if name != TP_Q8_FULL:
        cfg = _tp_cfg(TP_Q8[1])
        state = make_state(cfg, opt, seed=0, device=dev)
        state["step"].fill_(50)
        return cfg, opt, state
    cfg = _tp_full_cfg()
    params = _tp_full_params(cfg, dev)
    moments = make_abstract_state(cfg, opt)["opt"] if zeros else init_state(params, opt)
    return cfg, opt, {"params": params, "opt": moments,
                      "step": torch.full((), 50, dtype=torch.int32, device=dev)}


def _q8_passes(state: dict) -> int:
    """The most passes of ``q8_shard.CHUNK`` positions that one leaf's q8
    update takes on this rank."""
    from repro_torch.optim import q8_shard
    from repro_torch.optim.adamw import param_nodes

    most = 0
    for p, m in param_nodes(state["params"], state["opt"]["m"]):
        plan = q8_shard._Plan(p, m["q"])
        a, b = plan.own(plan.i, plan.j)
        most = max(most, -(-(b - a) // q8_shard.CHUNK))
    return most


def q8_check(card: str, dev: torch.device, mesh: tuple, got: list, name: str,
             out_dir: str) -> None:
    """The q8 case ``name`` (``TP_Q8`` or ``TP_Q8_FULL``) on each rank of
    ``mesh``: step by step against the card's one-device q8 run (fp32,
    TF32 off), the first step from the initial state and each later one
    from the ranks' own state after the step before (their shards joined,
    read from the ranks' files in ``out_dir``), as
    ``tests/test_torch_mesh_train.py`` holds its q8 run: the losses and
    every leaf's shard within ``TP_TOL`` of the leaf's largest value, ``q``
    within one quantum, a parameter beyond lr x the change of the step's
    Adam step for a gradient change of ``TP_TOL`` of the leaf's largest
    gradient (as :func:`tp_check` allows the other cases); and the train
    steps' all-gathers: none over ``data`` of a ``q``/``scale`` leaf's
    shape, none over ``model`` of a leaf split over it, and over ``data``
    only the FSDP gathers of the forward pass and remat's recompute (no
    gradient gathered back). Every check raises."""
    from repro_torch.models.model import demo_batch
    from repro_torch.optim import q8_shard
    from repro_torch.optim.adamw import cosine_schedule, dequantize_q8, param_nodes
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths, unflatten

    t0 = time.perf_counter()
    cfg, opt, state = _q8_case(name, dev)
    abstract = make_abstract_state(cfg, opt)
    sh = state_shardings(abstract, {"data": mesh[0], "model": mesh[1]}, cfg, fsdp=True)
    specs = {p: s.spec for p, s in leaves_with_paths(sh)}
    q8_rows = {tuple(t.shape) for p, t in leaves_with_paths(abstract["opt"])
               if p.endswith(("/q", "/scale"))}
    on_data = [p for p, s in leaves_with_paths(sh["params"]) if "data" in s.spec]
    fsdp = [p for p in on_data if p.startswith("blocks/")]
    expect = (2 * len(fsdp) * cfg.n_blocks + len(on_data) - len(fsdp)) * TP_TRAIN_STEPS
    for r, rank in enumerate(got):
        g = rank[name]
        if g["bad"] or q8_rows & set(g["data_gathered"]) or g["data_gathers"] != [expect]:
            raise AssertionError(
                f"dist: {name} rank {r} gathered model-split leaves over model "
                f"{g['bad'][:3]}, q8 rows over data {sorted(q8_rows & set(g['data_gathered']))}"
                f", or made {g['data_gathers']} all-gathers over data, not [{expect}]")

    def saved(r: int, i: int) -> dict:
        """Rank ``r``'s state after step ``i + 1``, mapped from its file."""
        return dict(leaves_with_paths(torch.load(
            os.path.join(out_dir, f"{name}-rank{r}-step{i}.pt"), mmap=True,
            weights_only=False)))

    def joined(i: int) -> dict:
        """The ranks' state after step ``i + 1``, their shards joined, on the card."""
        mine = [saved(r, i) for r in range(len(got))]
        out = []
        for path, t in leaves_with_paths(abstract):
            whole = torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for r, part in enumerate(mine):
                _tp_cut(whole, specs[path], _tp_at(r, mesh), mesh).copy_(part[path])
            out.append(whole)
        return unflatten(abstract, out)

    def allowance(state: dict, batch: dict) -> dict:
        """lr x |s(g +- d) - s(g)| for the q8 Adam step s of each parameter
        entry from ``state`` with its one-device gradient g, d = ``TP_TOL``
        x the leaf's largest |g| (in fp64, kept in fp32 on the card)."""
        _, grads = loss_and_grads(state["params"], batch, cfg)
        norm = sum(float(x.double().square().sum()) for x in leaves(grads)) ** 0.5
        clip = min(1.0, opt.grad_clip / (norm + 1e-9))
        count = int(state["opt"]["count"]) + 1
        bc1, bc2 = 1 - opt.b1 ** count, 1 - opt.b2 ** count
        lr = opt.lr * float(cosine_schedule(state["step"]))
        out = {}
        nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"], grads)
        for (path, _), (p, m, v, g) in zip(leaves_with_paths(state["params"]), nodes):
            M = dequantize_q8(m, p.shape).double()
            V = dequantize_q8(v, p.shape).double()
            g = g.double() * clip

            def s(x, M=M, V=V):
                return ((opt.b1 * M + (1 - opt.b1) * x) / bc1) / (
                    torch.sqrt((opt.b2 * V + (1 - opt.b2) * x * x) / bc2) + opt.eps)

            d = TP_TOL * float(g.abs().max())
            out[path] = (lr * torch.maximum((s(g + d) - s(g)).abs(),
                                            (s(g - d) - s(g)).abs())).float()
            del M, V, g
        return out

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"params": 0.0, "moments": 0.0, "q": 0}
    try:
        step = make_train_step(cfg, opt)
        for i in range(TP_TRAIN_STEPS):
            batch = demo_batch(cfg, TP_BATCH, TP_SEQ, kind="train", seed=i, device=dev)
            if i > 0:
                del state
                state = joined(i - 1)
            allow = allowance(state, batch)
            state, metrics = step(state, batch)
            want_loss = float(metrics["loss"])
            ref = dict(leaves_with_paths(state))
            top = {path: max(float(t.abs().max()), 1e-30) for path, t in ref.items()}
            for r, rank in enumerate(got):
                loss = rank[name]["losses"][i]
                if abs(loss - want_loss) > TP_TOL * abs(want_loss):
                    raise AssertionError(f"dist: {name} rank {r} step {i + 1} loss {loss} "
                                         f"against the one-device run's {want_loss}")
                mine, at = saved(r, i), _tp_at(r, mesh)
                for path, whole in ref.items():
                    part = _tp_cut(whole, specs[path], at, mesh)
                    a = mine[path]
                    if a.shape != part.shape or a.dtype != part.dtype:
                        raise AssertionError(f"dist: {name} rank {r} {path}: "
                                             f"{tuple(a.shape)} {a.dtype}, not "
                                             f"{tuple(part.shape)} {part.dtype}")
                    a = a.to(dev)
                    if path.endswith("/q"):
                        err = int((a.int() - part.int()).abs().max())
                        worst["q"] = max(worst["q"], err)
                        if err > 1:
                            raise AssertionError(f"dist: {name} rank {r} step {i + 1} "
                                                 f"{path}: {err} quanta apart")
                        continue
                    diff = (a.double() - part.double()).abs()
                    key = path.removeprefix("params/")
                    if path.startswith("params/"):
                        diff = diff - _tp_cut(allow[key], specs[path], at, mesh).double() \
                            * (1 + 1e-6)
                    err = float(diff.max()) / top[path]
                    kind = "params" if path.startswith("params/") else "moments"
                    worst[kind] = max(worst[kind], err)
                    if err > TP_TOL:
                        raise AssertionError(f"dist: {name} rank {r} step {i + 1} {path}: "
                                             f"{err:.3e} of its largest value > {TP_TOL}")
                    del a, diff
            del allow, ref
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del state
    torch.cuda.empty_cache()
    base = TP_Q8[1] if name == TP_Q8[0] else (
        f"{TP_FSDP_FULL[1]} at full width (d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}) in fp32, {cfg.n_blocks} blocks,")
    log("dist", f"[{card}] (e) {name} at {mesh}: {base} with 8-bit AdamW moments and "
        f"FSDP, {TP_TRAIN_STEPS} train steps, each rank updating the q8 rows it holds "
        f"(a leaf in at most {[g[name]['passes'] for g in got]} passes of "
        f"{q8_shard.CHUNK} positions a rank): step by step == the card's one-device q8 run "
        f"(losses {got[0][name]['losses']}; worst "
        f"relative error of a parameter shard beyond the Adam allowance "
        f"{worst['params']:.2e}, of a scale or other leaf {worst['moments']:.2e}, q "
        f"{worst['q']} quanta; bound {TP_TOL}, q one quantum); all-gathers over data a "
        f"rank {[g[name]['data_gathers'][0] for g in got]} == the forward's FSDP gathers "
        f"{expect}, none of a q/scale leaf's {len(q8_rows)} shapes, none over model of a "
        f"leaf split over it; all-to-alls over data a rank "
        f"{[g[name]['data_all_to_all'] for g in got]}; the case "
        f"{got[0]['times'][f'{name}_s']} s of a rank, its check "
        f"{time.perf_counter() - t0:.1f} s")


def expert_flops(shapes: set):
    """A dispatch mode whose ``calls`` lists the flops of every op that
    ``FlopCounterMode`` counts and that reads an expert weight (an operand
    of one of ``shapes``: (E, D, F/m) or (E, F/m, D), whole over ``data``):
    the SwiGLU's three matmuls forward and their input gradients backward,
    2 E S D F/m each for the S capacity slots the rank ran them on."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class ExpertFlops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls: list[int] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and any(isinstance(t, torch.Tensor) and
                                           tuple(t.shape) in shapes for t in args):
                self.calls.append(int(formula(*args, **(kwargs or {}), out_val=out)))
            return out

    return ExpertFlops()


def _capacity(cfg, tokens: int) -> int:
    """``moe``'s C for a call over ``tokens`` tokens of the whole batch."""
    c = int(np.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, min(c, tokens))


def capacity_check(mesh: tuple, name: str, cfg, seq: int, got: list) -> str:
    """The capacity split's signature on each rank of ``mesh`` for the MoE
    case ``name`` (``cfg``, its prefill and train batches of ``TP_BATCH`` x
    ``seq`` tokens; ``got``: each rank's results of the case): every expert
    matmul ran on C/d slots by its counted flops (:func:`expert_flops`),
    for the C of its call (the prefill's and train steps', or a decode
    step's), three a MoE sublayer a pass and three more backward; over
    ``data`` one all-gather of the d data shares' rows (D + K columns) a
    MoE sublayer a pass (the prefill, each decode step, and twice a train
    step: the forward and remat's), and no collective of a whole (E, C, D)
    buffer's bytes. Raises; returns the log's words."""
    d, m = mesh
    E, D, K = cfg.n_experts, cfg.d_model, cfg.top_k
    caps = {_capacity(cfg, TP_BATCH * seq), _capacity(cfg, TP_BATCH)}
    if E % m == 0 or any(c % d for c in caps):
        raise AssertionError(f"dist: {name} at {mesh} does not take the capacity split "
                             f"(E {E}, C {sorted(caps)})")
    per_slot = 2 * E * D * (cfg.d_ff // m)
    want = {c // d for c in caps}
    passes = cfg.n_layers // cfg.moe_every * (1 + TP_DECODE + 2 * TP_TRAIN_STEPS)
    rows = {TP_BATCH * t * (D + K) * 4 for t in (seq, 1)}
    whole = {E * c * D * 4 for c in caps}
    for r, g in enumerate(got):
        slots = {n // per_slot for n in g["experts"]}
        if slots != want or any(n % per_slot for n in g["experts"]):
            raise AssertionError(f"dist: {name} rank {r}: expert matmuls on {sorted(slots)} "
                                 f"slots, not {sorted(want)}: the MoE capacity did not "
                                 "split over data")
        gathers = sum(k == "all-gather" and n in rows for k, n in g["data_log"])
        if gathers != passes or \
                len(g["experts"]) != 3 * (passes + cfg.n_layers // cfg.moe_every * TP_TRAIN_STEPS):
            raise AssertionError(f"dist: {name} rank {r}: {gathers} all-gathers over data of "
                                 f"the rows and {len(g['experts'])} expert matmuls for "
                                 f"{passes} MoE sublayer passes")
        big = [n for _, n in g["data_log"] if n in whole]
        if big:
            raise AssertionError(f"dist: {name} rank {r}: {len(big)} collectives over data "
                                 f"of a whole (E, C, D) buffer's bytes {sorted(set(big))}")
    return (f"{name}: expert matmuls on {sorted(want)} slots a rank (C {sorted(caps)} "
            f"over {d}, by their flops), {passes} MoE sublayer passes and as many "
            f"all-gathers of the rows over data a rank, no collective over data of "
            f"{sorted(whole)} B")


def tp_rank(rank: int, port: int, out_dir: str, device_type: str = "cuda",
            mesh_arg: str = "1,2") -> int:
    """``chip_smoke.py --tp-rank RANK PORT DIR [DEVICE [D,M]]``: one of the
    dist phase's tensor-parallel ranks, on the card, in a gloo group of the
    ranks of a (D, M) mesh (``TP_MESH`` or ``TP_MESH_DP``) at
    ``localhost:PORT``: its smoke configs' (``_tp_cases``) mesh prefill,
    decode and train steps (at ``TP_MESH_DP`` ``TP_FSDP_FULL``'s and
    ``TP_MOE_FULL``'s too, their weights drawn on the card, the q8 cases' train steps, each step's
    state written to ``DIR/{case}-rank{RANK}-step{i}.pt``, and the batch-1
    cases, :func:`seq_split_rank`), and, where
    ``DIR/inputs.pt`` holds the lm
    phase's prompt batch, mamba2-780m at full width in fp32 over it (one
    decode step under ``FlopCounterMode``), under the collective counter;
    writes ``DIR/rank{RANK}.pt``. (``device_type`` ``"cpu"`` runs it on the
    host, for a rehearsal.)"""
    if device_type == "cuda" and not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from dataclasses import replace

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models.model import build_params, demo_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import (local, make_mesh_decode_step,
                                             make_mesh_prefill_step, make_mesh_train_step)
    from repro_torch.train.state import make_abstract_state, make_state, state_shardings
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0)
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    shape = tuple(int(x) for x in mesh_arg.split(","))
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                             world_size=shape[0] * shape[1])
    try:
        mesh = init_device_mesh(device_type, shape, mesh_dim_names=("data", "model"))
        group = mesh.get_group("model").group_name
        data_group = mesh.get_group("data").group_name
        at = {"data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}

        def place(tree, shardings):
            """The rank's shards, cut from the whole and made the rank's own
            on the card (a ``meta`` leaf gives zeros of the shard's shape)."""
            def one(t, s):
                part = _tp_cut(t, s.spec, at, shape)
                if part.is_meta:
                    part = torch.zeros(part.shape, dtype=part.dtype, device=dev)
                elif part.device == dev:  # not a view of the whole
                    part = part.clone(memory_format=torch.contiguous_format)
                else:
                    part = part.to(dev)
                return DTensor.from_local(part, mesh, list(s.placements()), run_check=False)

            return tree_map(one, tree, shardings)

        def forbidden(tree, shardings) -> set:
            """The shapes of the leaves split over model, whole and a block."""
            specs = dict(leaves_with_paths(shardings))
            out = set()
            for p, t in leaves_with_paths(tree):
                if "model" in str(specs[p].spec):
                    out |= {tuple(t.shape), tuple(t.shape[1:])} if "blocks" in p \
                        else {tuple(t.shape)}
            return out

        def report(counters, bad_shapes) -> dict:
            return {"bad": [s for c in counters for g, s in c.gathered
                            if g == group and s in bad_shapes],
                    "model_calls": sum(n for c in counters for (g, _), n in c.by_group.items()
                                       if g == group),
                    "data_all_to_all": sum(n for c in counters
                                           for (g, k), n in c.by_group.items()
                                           if g == data_group and k == "all-to-all"),
                    "data_gathers": [c.by_group[data_group, "all-gather"] for c in counters]}

        results: dict = {"smoke": {}, "times": {}}
        inputs = os.path.join(out_dir, "inputs.pt")
        results["at"] = at
        full_cfg = replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE, dtype="float32")
        drawn: dict = {}
        # the full-width weights are drawn on the host while the smoke
        # configs run (torch's generator releases the interpreter lock)
        draw = threading.Thread(target=lambda: drawn.update(
            params=build_params(full_cfg, seed=0, device="cpu")), daemon=True)
        if os.path.exists(inputs):
            draw.start()
        def run(cfg, opt, state, sh, bad, fsdp: bool, seq: int = TP_SEQ) -> tuple[dict, dict]:
            """A case's mesh prefill, decode and train steps (``seq``
            tokens a row), with the flops of its expert matmuls; the
            results (with ``fsdp`` the device memory of the train steps)
            and the state after them."""
            Fl = cfg.d_ff // shape[1]
            shapes = {(cfg.n_experts, cfg.d_model, Fl), (cfg.n_experts, Fl, cfg.d_model)}
            ef = expert_flops(shapes if cfg.n_experts else set())
            with CollectiveCounter() as cc, ef:
                logits, cache = make_mesh_prefill_step(cfg, mesh, max_seq=seq + TP_DECODE)(
                    state["params"], demo_batch(cfg, TP_BATCH, seq, kind="prefill",
                                                seed=1, device=dev))
                decode = make_mesh_decode_step(cfg, mesh)
                steps = []
                for i in range(TP_DECODE):
                    tok = demo_batch(cfg, TP_BATCH, 1, kind="decode", seed=2 + i, device=dev)
                    lg, cache = decode(state["params"], cache, tok)
                    steps.append(lg.cpu())
            del cache
            step = make_mesh_train_step(cfg, opt, mesh, sh)
            losses = []
            if fsdp and device_type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with CollectiveCounter() as tc, ef:
                for i in range(TP_TRAIN_STEPS):
                    state, metrics = step(state, demo_batch(cfg, TP_BATCH, seq,
                                                            kind="train", seed=i, device=dev))
                    losses.append(float(metrics["loss"]))
            out = {"logits": logits.cpu(), "steps": steps, "losses": losses,
                   "experts": ef.calls,
                   "data_log": [(k, n) for c in (cc, tc) for g, k, n in c.log
                                if g == data_group],
                   **report([cc, tc], bad)}
            if fsdp:
                out["memory"] = fsdp_memory(state, cfg, mesh, demo_batch(
                    cfg, TP_BATCH, TP_SEQ, kind="train", seed=0, device=dev), device_type)
            return out, state

        t0 = time.perf_counter()
        for name in _tp_cases(shape):
            cfg = _tp_cfg(name)
            opt = AdamWConfig()
            whole = make_state(cfg, opt, seed=0, device="cpu")
            whole["step"].fill_(50)
            fsdp = name in TP_FSDP
            sh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg, fsdp=fsdp)
            out, state = run(cfg, opt, place(whole, sh), sh,
                             forbidden(whole["params"], sh["params"]), fsdp)
            results["smoke"][name] = {**out,
                                      "state": tree_map(lambda t: local(t).cpu(), state)}
        results["times"]["smoke_s"] = round(time.perf_counter() - t0, 1)
        if shape == TP_MESH_DP:
            # the q8 cases: the rank's state after each train step (to a
            # file each: at full width a rank's state is GBs), the passes
            # its largest leaf took, and the steps' all-gathers
            for name in (TP_Q8[0], TP_Q8_FULL):
                t0 = time.perf_counter()
                cfg, opt, whole = _q8_case(name, dev if name == TP_Q8_FULL else "cpu",
                                           zeros=True)
                abstract = make_abstract_state(cfg, opt)
                sh = state_shardings(abstract, mesh, cfg, fsdp=True)
                state = place(whole, sh)
                del whole
                passes = _q8_passes(state)
                step = make_mesh_train_step(cfg, opt, mesh, sh)
                losses = []
                with CollectiveCounter() as tc:
                    for i in range(TP_TRAIN_STEPS):
                        state, metrics = step(state, demo_batch(
                            cfg, TP_BATCH, TP_SEQ, kind="train", seed=i, device=dev))
                        losses.append(float(metrics["loss"]))
                        torch.save(tree_map(lambda t: local(t).cpu(), state),
                                   os.path.join(out_dir, f"{name}-rank{rank}-step{i}.pt"))
                results[name] = {"losses": losses, "passes": passes,
                                 "data_gathered": [s for g, s in tc.gathered
                                                   if g == data_group],
                                 **report([tc], forbidden(abstract["params"], sh["params"]))}
                del state
                if device_type == "cuda":
                    torch.cuda.empty_cache()
                results["times"][f"{name}_s"] = round(time.perf_counter() - t0, 1)
            # yi-9b at full width with FSDP, its weights drawn on the card
            t0 = time.perf_counter()
            cfg, opt = _tp_full_cfg(), AdamWConfig()
            abstract = make_abstract_state(cfg, opt)
            sh = state_shardings(abstract, mesh, cfg, fsdp=True)
            whole = {"params": _tp_full_params(cfg, dev), "opt": abstract["opt"],
                     "step": torch.full((), 50, dtype=torch.int32)}
            state = place(whole, sh)
            del whole
            if device_type == "cuda":
                torch.cuda.empty_cache()
            results[TP_FSDP_FULL[0]], state = run(
                cfg, opt, state, sh, forbidden(abstract["params"], sh["params"]), True)
            del state
            results["times"]["fsdp_full_s"] = round(time.perf_counter() - t0, 1)
            # mixtral at full width with 3 experts and FSDP: the capacity
            # over data at 4,096 tokens, its weights drawn on the card
            t0 = time.perf_counter()
            cfg, opt = _moe_full_cfg(), AdamWConfig()
            abstract = make_abstract_state(cfg, opt)
            sh = state_shardings(abstract, mesh, cfg, fsdp=True)
            whole = {"params": _tp_full_params(cfg, dev), "opt": abstract["opt"],
                     "step": torch.full((), 50, dtype=torch.int32)}
            state = place(whole, sh)
            del whole
            if device_type == "cuda":
                torch.cuda.empty_cache()
            results[TP_MOE_FULL[0]], state = run(
                cfg, opt, state, sh, forbidden(abstract["params"], sh["params"]), False,
                seq=TP_MOE_SEQ)
            del state
            if device_type == "cuda":
                torch.cuda.empty_cache()
            results["times"]["moe_full_s"] = round(time.perf_counter() - t0, 1)
            # batch 1: the caches' sequence split over data
            t0 = time.perf_counter()
            results["seq"] = seq_split_rank(mesh, dev, place, data_group)
            results["times"]["seq_s"] = round(time.perf_counter() - t0, 1)
        if os.path.exists(inputs):
            t0 = time.perf_counter()
            inp = torch.load(inputs, weights_only=False)
            cfg = full_cfg
            draw.join()
            params = drawn.pop("params")
            sh = param_shardings(params, mesh, cfg)
            bad = forbidden(params, sh)
            placed = place(params, sh)
            embed_spec = dict(leaves_with_paths(sh))["embed"].spec
            del params
            results["times"]["weights_wait_s"] = round(time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            with torch.no_grad(), CollectiveCounter() as cc:
                lg, cache = make_mesh_prefill_step(cfg, mesh, max_seq=inp["max_seq"])(
                    placed, {"tokens": inp["tokens"].to(dev)})
                got = [lg.cpu()]
                decode = make_mesh_decode_step(cfg, mesh)
                with FlopCounterMode(display=False) as fc:
                    lg, cache = decode(placed, cache, {"token": inp["ids"][0].to(dev)})
                got.append(lg.cpu())
                for ids in inp["ids"][1:]:
                    lg, cache = decode(placed, cache, {"token": ids.to(dev)})
                    got.append(lg.cpu())
            results["times"]["full_s"] = round(time.perf_counter() - t0, 1)
            results["full"] = {
                "logits": got, "decode_flops": int(fc.get_total_flops()),
                "param_bytes": sum(local(t).numel() * local(t).element_size()
                                   for t in leaves(placed)),
                "heads": local(placed["blocks"]["l0"]["ssm"]["A_log"]).shape[-1],
                "vocab": cfg.vocab_size,
                "embed": "vocabulary" if embed_spec[0] == "model" else
                         "columns" if embed_spec[1] == "model" else "nothing",
                **report([cc], bad)}
        results["times"]["all_s"] = round(time.perf_counter() - t_start, 1)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        print(f"tp-rank {rank}: {results['times']}", flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


def fsdp_memory(state: dict, cfg, mesh, batch: dict, device_type: str) -> dict:
    """A (2, 2) rank's device memory around its FSDP train steps: their
    peak (``max_memory_allocated`` since the steps began), what is
    allocated after them (the state), and the peak of one loss and
    gradient pass of ``batch`` on that state with every FSDP leaf gathered
    over ``data`` at the pass's start, as a step that gathers the whole
    tree holds them until its gradients are done (the mesh train step's
    model, per-block autograd leaves, gathers and reduce-scatters; only
    where the blocks' gathers happen differs); and the bytes of one
    block's FSDP leaves gathered (the rank's ``model`` shard). The device
    numbers are None on the host."""
    from repro_torch.distributed.sharding import mesh_shape, use_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import loss_fn
    from repro_torch.models.transformer import STACKS
    from repro_torch.train import mesh_step as ms
    from repro_torch.tree import leaves, tree_map

    params = state["params"]
    block = sum(ms.local(p)[0].numel() * p.element_size() * mesh_shape(mesh)["data"]
                for p in leaves(params["blocks"])
                if ms._fsdp_dim(mesh, p.placements) is not None)
    if device_type != "cuda":
        return {"step": None, "state": None, "whole": None, "block_bytes": block}
    torch.cuda.synchronize()
    step, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tree, flat, _ = ms._block_leaves(tree_map(ms.local, params))
    share, split = ms._share(batch, mesh)
    gather, fetch = ms._fsdp(mesh, params, split)
    with use_mesh(mesh), torch.enable_grad(), \
            layers.split_batch(ms._dp_groups(mesh) if split else []):
        whole = {**gather(tree), **{k: [fetch(b, k) for b in tree[k]]
                                    for k in STACKS if k in tree}}
        loss = loss_fn(whole, share, cfg, True)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del grads, whole, loss, tree, flat
    return {"step": step, "state": held, "whole": peak, "block_bytes": block}


def start_dryrun_probe() -> subprocess.Popen:
    """``chip_smoke.py --dryrun-probe`` in a child process, killed at exit
    if it is still running."""
    import atexit

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun-probe"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_probe() -> int:
    """``chip_smoke.py --dryrun-probe``: the port's dry-run of the train
    phase's full-width step (mamba2-780m with the tokenizer's vocabulary,
    bf16, batch ``TRAIN_BATCH`` x seq ``TRAIN_SEQ``, one rank of a (1, 1)
    mesh), traced on ``meta`` tensors on the host under a fake process
    group; print its record's counts and roofline terms as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from dataclasses import replace

    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeConfig

    cfg = replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE)
    t0 = time.perf_counter()
    d = dryrun.trace_step(cfg, ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"),
                          1, lambda dt: make_host_mesh(1, 1, device_type=dt))
    rec = {"flops": d["flops"], "ops": d["ops"],
           "argument_size_in_bytes": d["argument_size_in_bytes"],
           "bytes_accessed": d["op_bytes"] + d["argument_size_in_bytes"],
           "collective_bytes_total": d["collective_bytes_total"],
           "collective_calls": d["collective_calls"],
           "peak_flops": dryrun.PEAK_FLOPS, "hbm_bw": dryrun.HBM_BW,
           "link_bw": dryrun.LINK_BW, "trace_s": time.perf_counter() - t0}
    rec.update(dryrun.roofline_terms(rec))
    print(json.dumps(rec), flush=True)
    return 0


def cluster_probe() -> int:
    """``chip_smoke.py --cluster-probe``: what shard server processes on one
    card read, and where a call's time goes. Builds the 32 MiB store of the
    main run, then for each layout spawns a ``LocalCluster`` of ``python -m
    repro_torch.net`` children, reads ``PROBE_CALLS`` of the read path's
    shuffled 1,024-id calls through ``connect("tcp://...")`` (checked
    against the source) and prints one JSON line a layout: lookups/s, the
    client's p50/p99 a call, and the servers' service p50/p99 (their merged
    histograms, by the stats RPC). Layouts: four children on the card;
    the same with one OpenMP thread a child; four on the host (``--device
    cpu``: no card to share); one child on the card over the whole store."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.client import connect
    from repro_torch.data.synth import load_dataset
    from repro_torch.distributed import save_sharded
    from repro_torch.loadgen import LocalCluster
    from repro_torch.loadgen.slo import collect_rpc_states, shard_clients
    from repro_torch.obs import diff_hist_states, merge_hist_states, summarize_hist_state
    from repro_torch.store import CompressedStringStore

    dev = torch.device("cuda")
    strings = load_dataset("book_titles", DATA_BYTES, seed=SEED)
    n_all = len(strings)
    store = CompressedStringStore.build(strings, sample_bytes=SAMPLE_BYTES, seed=SEED,
                                        device=dev, cache_bytes=0,
                                        strings_per_segment=STRINGS_PER_SEGMENT)
    order = np.random.default_rng(SEED).permutation(n_all)
    calls = [order[i : i + MULTIGET_IDS].tolist()
             for i in range(0, PROBE_CALLS * MULTIGET_IDS, MULTIGET_IDS)]
    pdir = tempfile.mkdtemp(prefix="chip-smoke-probe-")
    try:
        for n_shards in (SERVE_SHARDS, 1):
            save_sharded(store, os.path.join(pdir, str(n_shards)), n_shards)
        for name, n_shards, device, env in (
                ("4 children, cuda", SERVE_SHARDS, "cuda", {}),
                ("4 children, cuda, OMP_NUM_THREADS=1", SERVE_SHARDS, "cuda",
                 {"OMP_NUM_THREADS": "1"}),
                ("4 children, cpu", SERVE_SHARDS, "cpu", {}),
                ("1 child, cuda", 1, "cuda", {})):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)  # the children inherit this environment
            try:
                t0 = time.perf_counter()
                cluster = LocalCluster.spawn(os.path.join(pdir, str(n_shards)),
                                             device=device)
                ready_s = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            try:
                with connect(cluster.url) as client:
                    client.multiget(calls[0])  # each child's first launch
                    before = collect_rpc_states(shard_clients(client))
                    lat = []
                    t0 = time.perf_counter()
                    for ids in calls:
                        t1 = time.perf_counter()
                        got = client.multiget(ids)
                        lat.append(time.perf_counter() - t1)
                        check_strings(f"probe {name}", got, [strings[i] for i in ids])
                    wall = time.perf_counter() - t0
                    after = collect_rpc_states(shard_clients(client))
            finally:
                cluster.close()
            server = summarize_hist_state(merge_hist_states(
                [diff_hist_states(a, b) for a, b in zip(after, before)]))
            p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
            print(json.dumps({"layout": name, "ready_s": round(ready_s, 2),
                              "lookups_per_s": round(len(calls) * MULTIGET_IDS / wall, 1),
                              "call_p50_ms": round(float(p50), 3),
                              "call_p99_ms": round(float(p99), 3),
                              "service_p50_ms": round(server["p50_us"] / 1e3, 3),
                              "service_p99_ms": round(server["p99_us"] / 1e3, 3),
                              "service_requests": server["count"]}), flush=True)
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
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


def open_probe(path: str, kind: str) -> int:
    """``chip_smoke.py --open-probe DIR read|writable``: in this fresh
    process, start CUDA and load the kernels, then time the open of the
    store saved in DIR and read every string back by shuffled 1,024-id
    multigets and by scan(0, n); print the seconds, the digests of both
    reads (in id order), the payload's sha256 prefix, the cold segments and
    the cold lookups as one JSON line."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.store import CompressedStringStore, MutableStringStore

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    _build.load()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cls = MutableStringStore if kind == "writable" else CompressedStringStore
    t0 = time.perf_counter()
    st = cls.open(path)  # on the card for OnPair16, on the host for other codecs
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    n = st.n_strings
    got: list = [None] * n
    perm = np.random.default_rng(SEED).permutation(n)
    for i in range(0, n, MULTIGET_IDS):
        ids = perm[i : i + MULTIGET_IDS]
        for k, v in zip(ids.tolist(), st.multiget(ids)):
            got[k] = v
    scanned = st.scan(0, n)
    print(json.dumps({"init_s": init_s, "open_s": open_s, "multiget": digest(got),
                      "scan": digest(scanned), "payload_sha256": hashlib.sha256(
                          st.snapshot_corpus().payload).hexdigest()[:16],
                      "cold": sorted(st.tier.cold) if st.tier is not None else [],
                      "cold_lookups": st.stats.cold_lookups}), flush=True)
    return 0


def lm_probe(src: str) -> int:
    """``chip_smoke.py --lm-probe SRC``: decode steps of the launcher's
    mamba2-780m at full width in bf16 (seed 0, batch 5 of 10 random ids),
    with ``repro_torch`` imported from SRC, a ``src`` directory, so that
    two trees compare in one call, each in a fresh process. After prefill
    and 2 unprofiled steps, ``LM_PROBE_STEPS`` steps are timed on the host
    clock after a synchronise and one more runs under the profiler; print
    the ms a step, the profiled step's wall, device ms and records, the
    peak device memory over the timed steps above the weights and cache
    before them, and the step's bound, as one JSON line."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.abspath(src))
    from dataclasses import replace

    from repro_torch.configs import REGISTRY
    from repro_torch.core.tokenizer import VOCAB_SIZE
    from repro_torch.models.model import build_params, serve_decode, serve_prefill

    dev = torch.device("cuda")
    cfg = replace(REGISTRY[LM_ARCH], vocab_size=VOCAB_SIZE)
    params = build_params(cfg, seed=0, device=dev)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (5, 10))
    with torch.inference_mode():
        logits, cache = serve_prefill(
            params, {"tokens": torch.from_numpy(ids.astype(np.int32)).to(dev)}, cfg)
        for _ in range(2):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            logits, cache = serve_decode(params, cache, {"token": tok}, cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(LM_PROBE_STEPS):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            logits, cache = serve_decode(params, cache, {"token": tok}, cfg)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / LM_PROBE_STEPS
        extra = torch.cuda.max_memory_allocated() - base
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        (wall, acts), _, _ = device_window(
            lambda: serve_decode(params, cache, {"token": tok}, cfg))
    nbytes = lm_step_bytes(params, cache, cfg, ids.shape[0])
    print(json.dumps({
        "src": src, "step_ms": step_s * 1e3, "finite": bool(torch.isfinite(logits).all()),
        "profiled_wall_ms": wall * 1e3,
        "device_ms": sum(sec for _, sec in acts.values()) * 1e3,
        "records": sum(n for n, _ in acts.values()),
        "peak_extra_gib": extra / 2**30,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_gb": nbytes / 1e9}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lm-probe"]:
        sys.exit(lm_probe(sys.argv[2]))
    if sys.argv[1:2] == ["--decode-all-probe"]:
        sys.exit(decode_all_probe(sys.argv[2]))
    if sys.argv[1:2] == ["--open-probe"]:
        sys.exit(open_probe(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--dryrun-probe"]:
        sys.exit(dryrun_probe())
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:7]))
    if sys.argv[1:2] == ["--cluster-probe"]:
        sys.exit(cluster_probe())
    sys.exit(main())
