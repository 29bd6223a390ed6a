// encode_batch for Hopper (sm_90a): OnPair16 greedy longest-prefix-match
// parse of a batch of strings, paper Algorithms 1-2 (§3.3-3.4).
//
// Replaces the Pallas TPU kernel `encode_batch_pallas` (body `_encode_kernel`
// in src/repro/kernels/onpair_encode.py, which runs `_lpm_search_ref` of
// src/repro/kernels/ref.py at every position).
//
// What bounds it on this card: latency. Every token is a chain of dependent
// loads — hash the 8-byte prefix, probe the prefix table, walk the bucket's
// suffixes, or probe the short table at up to 8 lengths — and the chain's
// length depends on the data, so the threads of a warp diverge. The bytes
// it must move (the padded strings, the table records it touches, the token
// rows) take well under a microsecond of HBM time; the store's 64-string
// batches occupy two warps of the card.
//
// Design: one thread per string, 32 threads a block, so the two warps of a
// 64-string batch land on two SMs. The tables (a few MB for a full
// dictionary) stay in global memory and live in L2 after first touch; a
// batch is too small to pay for staging them in shared memory. The hashes
// are the reference's `mix32`/`hash_key` in native uint32 arithmetic, and
// the tie rules are the reference's: the long tier only when more than 8
// bytes remain, suffixes in bucket order (descending length, ties in id
// order), the first fitting match wins; a probe stops at the first empty
// slot or after probe_max probes; the short tier tries min(rem, 8) .. 1
// bytes; no match at all emits token 0 of length 1. The parse stops quietly
// at max_tokens, and the token row's tail is written with zeros.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Linear probe; payload of the matching slot, or -1.
__device__ int probe(const Table& t, uint32_t lo, uint32_t hi, int len) {
  const uint32_t slot0 = hash_key(lo, hi, static_cast<uint32_t>(len)) & t.mask;
  for (int i = 0; i < t.probe_max; ++i) {
    const uint32_t s = (slot0 + static_cast<uint32_t>(i)) & t.mask;
    const int sl = t.len[s];
    if (sl == 0) return -1;
    if (sl == len && t.lo[s] == lo && t.hi[s] == hi) return t.payload[s];
  }
  return -1;
}

__global__ void encode_batch_kernel(const uint8_t* __restrict__ data,
                                    const int32_t* __restrict__ lens, Dict d,
                                    int32_t* __restrict__ tokens,
                                    int32_t* __restrict__ n_tokens, int B,
                                    int Lp, int max_tokens) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = data + static_cast<size_t>(b) * Lp;
  int32_t* out = tokens + static_cast<size_t>(b) * max_tokens;
  // every window of 16 bytes at pos < len stays inside the padded row
  const int len = max(0, min(lens[b], Lp - 16));
  int pos = 0;
  int count = 0;
  while (pos < len && count < max_tokens) {
    const int rem = len - pos;
    const uint8_t* w = row + pos;
    const uint32_t lo1 = load_u32(w);
    const uint32_t hi1 = load_u32(w + 4);
    int tok = -1;
    int mlen = 0;
    if (rem > 8) {  // long tier
      const int bucket = probe(d.p, lo1, hi1, 8);
      if (bucket >= 0) {
        const uint32_t lo2 = load_u32(w + 8);
        const uint32_t hi2 = load_u32(w + 12);
        const int start = d.bucket_start[bucket];
        const int size = min(d.bucket_size[bucket], d.max_bucket);
        for (int k = 0; k < size; ++k) {
          const int i = start + k;
          const int sl = d.suf_len[i];
          if (sl <= rem - 8 &&
              shared_prefix_bytes(lo2, hi2, d.suf_lo[i], d.suf_hi[i]) >= sl) {
            tok = d.suf_tok[i];
            mlen = 8 + sl;
            break;
          }
        }
      }
    }
    if (tok < 0) {  // short tier
      tok = 0;
      mlen = 1;
      for (int l = min(rem, 8); l >= 1; --l) {
        const int c = probe(d.s, lo1 & byte_mask(l), hi1 & byte_mask(l - 4), l);
        if (c >= 0) {
          tok = c;
          mlen = l;
          break;
        }
      }
    }
    out[count++] = tok;
    pos += mlen;
  }
  n_tokens[b] = count;
  for (int t = count; t < max_tokens; ++t) out[t] = 0;
}

}  // namespace

extern "C" int onpair_encode_batch(
    const void* data, const void* lens, const void* s_lo, const void* s_hi,
    const void* s_len, const void* s_tok, const void* p_lo, const void* p_hi,
    const void* p_len, const void* p_bucket, const void* bucket_start,
    const void* bucket_size, const void* suf_lo, const void* suf_hi,
    const void* suf_len, const void* suf_tok, void* tokens, void* n_tokens,
    int B, int Lp, int max_tokens, int s_size, int p_size, int s_probe_max,
    int p_probe_max, int max_bucket, void* stream) {
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
  constexpr int kThreads = 32;
  const int blocks = (B + kThreads - 1) / kThreads;
  encode_batch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lens), d,
      static_cast<int32_t*>(tokens), static_cast<int32_t*>(n_tokens), B, Lp,
      max_tokens);
  return static_cast<int>(cudaGetLastError());
}
