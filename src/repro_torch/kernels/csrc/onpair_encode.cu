// encode_batch for Hopper (sm_90a): OnPair16 greedy longest-prefix-match
// parse of a batch of strings, paper Algorithms 1-2 (§3.3-3.4).
//
// Replaces the Pallas TPU kernel `encode_batch_pallas` (body `_encode_kernel`
// in src/repro/kernels/onpair_encode.py, which runs `_lpm_search_ref` of
// src/repro/kernels/ref.py at every position).
//
// What bounds it on this card: latency, and then how many strings are in
// flight. Each token is a short chain of dependent loads — the 16-byte
// window at the parse position, the prefix-table probe, the bucket bounds,
// the bucket's suffixes, or the short-table probes — whose length depends on
// the data. The bytes the parse must move (the strings, the token rows, the
// table records it touches) take microseconds of HBM time even for a whole
// corpus, so a launch can only approach that if every SM holds many strings
// at once and each link of a chain is one round of loads, not a loop of them.
//
// Design: a warp per string, 8 warps a block, and a grid over every string
// of the call (the host hands it tens of thousands of strings a launch).
// The lanes share each token's search, so each step is one round of
// coalesced loads:
// - the window: lanes 0-4 read the five aligned u32 words around it (one
//   byte per lane, lanes 0-15, where rows are not 4-byte aligned), and
//   funnel shifts and shuffles give every lane the four packed words;
// - the long tier (more than 8 bytes left): lane i reads prefix slot
//   slot0 + i, 32 slots a round; the key's bucket is at the lowest lane that
//   holds the key if no lower lane is empty, which is the serial probe's
//   rule (a probe stops at the first empty slot or after probe_max slots);
// - the bucket walk: lane k tests suffix k of the bucket, 32 a round (at
//   most 4 rounds for a bucket of 128); the first fit in bucket order is
//   `__ffs` of the ballot;
// - the short tier, when the long tier finds nothing: the 8 lengths
//   min(rem, 8) .. 1 are probed side by side, 4 lanes (4 consecutive slots)
//   per length a round, and the longest length that hits wins; no hit at all
//   emits token 0 of length 1.
// Lane (count mod 32) keeps each token in a register, and the warp writes
// 32 tokens at a time as one coalesced store; the parse stops quietly at
// max_tokens, and the row's tail is written with zeros the same way. The
// tables stay in global memory (a full dictionary's are a few MB) and are
// read through L1/L2. The hashes are the reference's `mix32`/`hash_key` in
// native uint32 arithmetic.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Table {
  const uint32_t* lo;
  const uint32_t* hi;
  const int32_t* len;
  const int32_t* payload;
  uint32_t mask;  // size - 1; sizes are powers of two
  int probe_max;
};

struct Dict {
  Table s;  // short tier: entries of 1..8 bytes
  Table p;  // long tier: 8-byte prefixes -> bucket ids
  const int32_t* bucket_start;
  const int32_t* bucket_size;
  const uint32_t* suf_lo;
  const uint32_t* suf_hi;
  const int32_t* suf_len;
  const int32_t* suf_tok;
  int max_bucket;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_key(uint32_t lo, uint32_t hi,
                                             uint32_t len) {
  return mix32(lo ^ mix32(hi ^ mix32(len)));
}

__device__ __forceinline__ int ctz32(uint32_t x) {
  return x ? __ffs(static_cast<int>(x)) - 1 : 32;
}

// Algorithm 2 on (lo, hi) u32 pairs: number of matching low-order bytes.
__device__ __forceinline__ int shared_prefix_bytes(uint32_t lo1, uint32_t hi1,
                                                   uint32_t lo2, uint32_t hi2) {
  const uint32_t dlo = lo1 ^ lo2;
  if (dlo != 0) return min(ctz32(dlo) >> 3, 4);
  return 4 + min(ctz32(hi1 ^ hi2) >> 3, 4);
}

// u32 mask over the low min(nbytes, 4) bytes (0 when nbytes <= 0).
__device__ __forceinline__ uint32_t byte_mask(int nbytes) {
  nbytes = max(0, min(nbytes, 4));
  return nbytes >= 4 ? 0xFFFFFFFFu : ((1u << (8 * nbytes)) - 1u);
}

// The 16 bytes at row[pos .. pos + 16) as four little-endian u32 words, in
// every lane. Aligned rows: lanes 0-4 load the words at a = pos & ~3 (the
// caller keeps a + 20 <= the row's end), and word k is the funnel shift of
// words k and k + 1 by the misalignment. Other rows: lanes 0-15 load a byte
// each and two xor-shuffles assemble the words in groups of four lanes.
__device__ __forceinline__ void load_window(const uint8_t* row, int pos,
                                            bool aligned, int lane,
                                            uint32_t w[4]) {
  if (aligned) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row + (pos & ~3));
    const uint32_t x = lane < 5 ? __ldg(words + lane) : 0u;
    const uint32_t y = __shfl_down_sync(kFull, x, 1);
    const uint32_t v = __funnelshift_r(x, y, 8 * (pos & 3));
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __shfl_sync(kFull, v, k);
  } else {
    uint32_t v = lane < 16
                     ? static_cast<uint32_t>(__ldg(row + pos + lane)) << (8 * (lane & 3))
                     : 0u;
    v |= __shfl_xor_sync(kFull, v, 1);
    v |= __shfl_xor_sync(kFull, v, 2);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __shfl_sync(kFull, v, 4 * k);
  }
}

// Warp-wide linear probe for one (lo, hi, len) key, 32 slots a round: the
// payload at the first slot (in probe order) that holds the key, provided
// no earlier slot is empty and it lies within probe_max slots; else -1.
__device__ __forceinline__ int probe_warp(const Table& t, uint32_t lo,
                                          uint32_t hi, int len, int lane) {
  const uint32_t slot0 = hash_key(lo, hi, static_cast<uint32_t>(len)) & t.mask;
  for (int base = 0; base < t.probe_max; base += 32) {
    const int i = base + lane;
    bool hit = false, stop = false;
    int pay = -1;
    if (i < t.probe_max) {
      const uint32_t s = (slot0 + static_cast<uint32_t>(i)) & t.mask;
      const int sl = __ldg(t.len + s);
      const uint32_t slo = __ldg(t.lo + s), shi = __ldg(t.hi + s);
      pay = __ldg(t.payload + s);
      hit = sl == len && slo == lo && shi == hi;
      stop = hit || sl == 0;
    }
    const uint32_t m = __ballot_sync(kFull, stop);
    if (m) return __shfl_sync(kFull, hit ? pay : -1, __ffs(m) - 1);
  }
  return -1;
}

// Algorithm 1's long tier: the first suffix of the key's bucket, in bucket
// order, that fits the bytes left and matches the window's second half.
// Returns the token (or -1) and sets mlen.
__device__ __forceinline__ int long_tier(const Dict& d, const uint32_t w[4],
                                         int rem, int lane, int& mlen) {
  const int bucket = probe_warp(d.p, w[0], w[1], 8, lane);
  if (bucket < 0) return -1;
  const int start = __ldg(d.bucket_start + bucket);
  const int size = min(__ldg(d.bucket_size + bucket), d.max_bucket);
  for (int base = 0; base < size; base += 32) {
    const int k = base + lane;
    bool fit = false;
    int sl = 0, tok = -1;
    if (k < size) {
      const int i = start + k;
      sl = __ldg(d.suf_len + i);
      const uint32_t slo = __ldg(d.suf_lo + i), shi = __ldg(d.suf_hi + i);
      tok = __ldg(d.suf_tok + i);
      fit = sl <= rem - 8 && shared_prefix_bytes(w[2], w[3], slo, shi) >= sl;
    }
    const uint32_t m = __ballot_sync(kFull, fit);
    if (m) {
      const int first = __ffs(m) - 1;
      mlen = 8 + __shfl_sync(kFull, sl, first);
      return __shfl_sync(kFull, tok, first);
    }
  }
  return -1;
}

// Algorithm 1's short tier: lane group g = lane / 4 probes length
// min(rem, 8) - g, its four lanes on four consecutive slots a round. A group
// is settled by its first stopping slot; the longest length that hits wins,
// and the rounds end once that is decided. No hit: token 0, length 1.
__device__ __forceinline__ int short_tier(const Dict& d, const uint32_t w[4],
                                          int rem, int lane, int& mlen) {
  const Table& t = d.s;
  const int maxlen = min(rem, 8);
  const int g = lane >> 2, j = lane & 3;
  const int len = maxlen - g;
  const uint32_t lo = w[0] & byte_mask(len), hi = w[1] & byte_mask(len - 4);
  const uint32_t slot0 = hash_key(lo, hi, static_cast<uint32_t>(len)) & t.mask;
  bool done = len < 1;
  int found = -1;
  for (int base = 0; base < t.probe_max; base += 4) {
    const int i = base + j;
    bool hit = false, stop = false;
    int pay = -1;
    if (!done && i < t.probe_max) {
      const uint32_t s = (slot0 + static_cast<uint32_t>(i)) & t.mask;
      const int sl = __ldg(t.len + s);
      const uint32_t slo = __ldg(t.lo + s), shi = __ldg(t.hi + s);
      pay = __ldg(t.payload + s);
      hit = sl == len && slo == lo && shi == hi;
      stop = hit || sl == 0;
    }
    const uint32_t mine = (__ballot_sync(kFull, stop) >> (4 * g)) & 0xFu;
    const int v = __shfl_sync(kFull, hit ? pay : -1,
                              4 * g + (mine ? __ffs(mine) - 1 : 0));
    if (mine) {
      done = true;
      found = v;
    }
    const uint32_t hits = __ballot_sync(kFull, found >= 0);
    const uint32_t open = __ballot_sync(kFull, !done);
    if (open == 0 || (hits != 0 && __ffs(hits) < __ffs(open))) break;
  }
  const uint32_t hits = __ballot_sync(kFull, found >= 0);
  if (hits == 0) {
    mlen = 1;
    return 0;
  }
  const int src = __ffs(hits) - 1;
  mlen = maxlen - (src >> 2);
  return __shfl_sync(kFull, found, src);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
encode_batch_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lens, Dict d,
                    int32_t* __restrict__ tokens,
                    int32_t* __restrict__ n_tokens, int B, int Lp,
                    int max_tokens, bool aligned) {
  const int b = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (b >= B) return;  // the whole warp: b is the same in every lane
  const uint8_t* row = data + static_cast<size_t>(b) * Lp;
  int32_t* out = tokens + static_cast<size_t>(b) * max_tokens;
  // every window of 16 bytes at pos < len stays inside the padded row
  const int len = max(0, min(__ldg(lens + b), Lp - 16));
  int pos = 0, count = 0;
  int held = 0;  // token (count mod 32) of the current 32, in that lane
  while (pos < len && count < max_tokens) {
    const int rem = len - pos;
    uint32_t w[4];
    load_window(row, pos, aligned, lane, w);
    int mlen = 0;
    int tok = rem > 8 ? long_tier(d, w, rem, lane, mlen) : -1;
    if (tok < 0) tok = short_tier(d, w, rem, lane, mlen);
    if (lane == (count & 31)) held = tok;
    ++count;
    pos += mlen;
    if ((count & 31) == 0) out[count - 32 + lane] = held;
  }
  // the last (count mod 32) tokens, then zeros to max_tokens, 32 a store
  for (int t = (count & ~31) + lane; t < max_tokens; t += 32)
    out[t] = t < count ? held : 0;
  if (lane == 0) n_tokens[b] = count;
}

}  // namespace

extern "C" int onpair_encode_batch(
    const void* data, const void* lens, const void* s_lo, const void* s_hi,
    const void* s_len, const void* s_tok, const void* p_lo, const void* p_hi,
    const void* p_len, const void* p_bucket, const void* bucket_start,
    const void* bucket_size, const void* suf_lo, const void* suf_hi,
    const void* suf_len, const void* suf_tok, void* tokens, void* n_tokens,
    int B, int Lp, int max_tokens, int s_size, int p_size, int s_probe_max,
    int p_probe_max, int max_bucket, int aligned, void* stream) {
  Dict d;
  d.s = {static_cast<const uint32_t*>(s_lo), static_cast<const uint32_t*>(s_hi),
         static_cast<const int32_t*>(s_len), static_cast<const int32_t*>(s_tok),
         static_cast<uint32_t>(s_size - 1), s_probe_max};
  d.p = {static_cast<const uint32_t*>(p_lo), static_cast<const uint32_t*>(p_hi),
         static_cast<const int32_t*>(p_len),
         static_cast<const int32_t*>(p_bucket),
         static_cast<uint32_t>(p_size - 1), p_probe_max};
  d.bucket_start = static_cast<const int32_t*>(bucket_start);
  d.bucket_size = static_cast<const int32_t*>(bucket_size);
  d.suf_lo = static_cast<const uint32_t*>(suf_lo);
  d.suf_hi = static_cast<const uint32_t*>(suf_hi);
  d.suf_len = static_cast<const int32_t*>(suf_len);
  d.suf_tok = static_cast<const int32_t*>(suf_tok);
  d.max_bucket = max_bucket;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  encode_batch_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lens), d,
      static_cast<int32_t*>(tokens), static_cast<int32_t*>(n_tokens), B, Lp,
      max_tokens, aligned != 0);
  return static_cast<int>(cudaGetLastError());
}
