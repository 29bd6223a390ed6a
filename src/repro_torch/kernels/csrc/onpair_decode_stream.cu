// decode_tokens for Hopper (sm_90a): OnPair16 decode of one token stream
// (any concatenation of compressed strings) into one byte stream.
//
// Replaces the Pallas TPU kernel `decode_gather` (body `_gather_kernel`) and
// the jnp compaction of `decode_tokens_pallas` around it, both in
// src/repro/kernels/onpair_decode.py. The TPU version gathers each token's
// int32[16] row into an int32[T, 16] intermediate and lets XLA scatter the
// ragged rows; this version does gather and compaction together and writes
// u8 bytes, with no [T, 16] intermediate.
//
// What bounds it on this card: bytes. The call must read each token once (2
// bytes as u16, the store's and a corpus's own layout; 4 as int32) and
// write each decoded byte once (about 8.6 per token on book titles); the
// dictionary (at most 1 MiB of rows and 64 KiB of uint8 lengths) stays in
// the 50 MB L2 after first touch. For the 32 MiB book-titles stream
// (3,905,093 tokens) that is about 41.8 MB with u16 tokens, 12.5 us at 3.35
// TB/s (49.6 MB and 14.8 us with int32). There is no arithmetic to speak
// of. What holds it above that bound is latency: every token costs two
// random lookups (its length, then its 16-byte row) through L1 and L2, and
// every tile waits for its predecessors' sums before it can write.
//
// Design: one launch, one read of each token, a single-pass chained scan
// (decoupled look-back, Merrill & Garland 2016).
//   * Tiles of kTile = 2,048 tokens: 256 threads x 8 consecutive tokens,
//     loaded as 16-byte vectors (one per thread for u16, two for int32).
//     A token range may start anywhere (a mirror range starts at any
//     string), so the launcher rounds the base pointer down to 16 bytes and
//     passes the `head` tokens it skipped: tile k covers padded positions
//     [k * kTile, (k + 1) * kTile) and position p is token p - head. A
//     vector is loaded only if it holds a valid token; the slots of the
//     head and past the end decode to nothing.
//   * Each thread gathers its 8 lengths and 8 16-byte rows at once (all in
//     flight together), sums its lengths, and joins a block scan: every
//     thread knows where its bytes start in the tile and the tile knows its
//     total. 8 tokens a thread keep 8 rows (32 registers) in flight; 2,048
//     tokens a tile keep the tile's image within 32 KB of static shared
//     memory, so four tiles share an SM (64 registers a thread). The
//     lengths come as uint8 (OnPair16's are at most 16): 64 KiB for a
//     full dictionary, which mostly stays in L1, where int32 lengths
//     (256 KiB) would mostly miss it and make every length wait on L2.
//   * Cross-tile prefix in the same launch: a tile takes its index from an
//     atomic ticket, not blockIdx, so every tile it waits on has started.
//     Warp 0 publishes the tile's aggregate, then looks back one warp-width
//     (32 predecessors) at a time, summing aggregates until it meets an
//     inclusive prefix, and publishes its own inclusive prefix. Flag and
//     value share one 64-bit status word (flag in bits 62-63, an int64 byte
//     offset below), so a single volatile load sees both; byte offsets stay
//     int64, so a stream past 2 GiB does not wrap.
//   * The tile's output is built in shared memory, aligned to the tile's
//     place in the output: image byte i is output byte (start & ~15) + i.
//     Each thread's bytes are one contiguous run, which it writes as whole
//     32-bit words (each token's row shifted into place with funnel
//     shifts); only the at most two words it shares with its neighbours are
//     written byte by byte. The block then copies the image to device memory
//     with 16-byte stores, byte stores only at the run's two ragged ends.
//     Tiles own disjoint output ranges; nothing is written at or past
//     max_out. The tile holding the last token writes out_len and zeroes
//     [out_len, max_out).
//   * Scratch: a ticket counter, a done counter and one status word per
//     tile. It starts zeroed (the launcher allocates it with zeros, once per
//     stream) and every call leaves it zeroed: the last tile to finish its
//     look-back (the done counter tells it) clears the status words and both
//     counters. So a call costs one launch and no memset, and two calls on
//     one stream never see each other's flags: the next call starts after
//     this one's clear.
// Tokens at or past n (clamped to [0, T]) decode to nothing; n == 0
// launches nothing. Token ids must be < the dictionary's size (the callers
// check host tokens; the store's mirror checks its tokens when it takes
// them).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // consecutive tokens per thread
constexpr int kTile = kThreads * kItems;    // tokens per tile
constexpr int kWarps = kThreads / 32;
constexpr int kImageChunks = kTile + 1;     // 16 B a token, plus the alignment
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Low min(max(k, 0), 4) bytes set.
__device__ __forceinline__ uint32_t byte_mask(int k) {
  return k >= 4 ? 0xffffffffu : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
}

// Bytes [lo, hi) of image word w, from v; a whole word in one store.
__device__ __forceinline__ void put_word(uint32_t* image, int w, uint32_t v,
                                         int lo, int hi) {
  if (lo == 0 && hi == 4) {
    image[w] = v;
    return;
  }
  uint8_t* b = reinterpret_cast<uint8_t*>(image + w);
  for (int j = lo; j < hi; ++j) b[j] = static_cast<uint8_t>(v >> (8 * j));
}

// The thread's kItems token ids from padded position p0 (a multiple of
// kItems, so the vectors are 16-byte aligned); vectors holding no token
// below `end` are not loaded.
template <typename Tok>
__device__ __forceinline__ void load_tokens(const Tok* __restrict__ base,
                                            long long p0, long long end,
                                            int (&tok)[kItems]) {
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(Tok));
#pragma unroll
  for (int v = 0; v < kItems / kPerVec; ++v) {
    const long long q = p0 + v * kPerVec;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (q < end) w = __ldg(reinterpret_cast<const uint4*>(base + q));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < kPerVec; ++k) {
      tok[v * kPerVec + k] =
          sizeof(Tok) == 2
              ? static_cast<int>((words[k >> 1] >> (16 * (k & 1))) & 0xffffu)
              : static_cast<int>(words[k]);
    }
  }
}

// Warp 0 of a tile: publish the tile's aggregate, look back for its
// exclusive prefix, publish its inclusive prefix. Returns the exclusive
// prefix (on every lane).
__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               int tile, int tile_bytes) {
  const int lane = threadIdx.x & 31;
  const unsigned long long agg = static_cast<unsigned long long>(tile_bytes);
  if (tile == 0) {
    if (lane == 0) store_status(status, kFlagPrefix | agg);
    return 0;
  }
  if (lane == 0) store_status(status + tile, kFlagAggregate | agg);
  long long excl = 0;
  for (int base = tile - 1;; base -= 32) {
    const int idx = base - lane;  // lane 0 reads the nearest predecessor
    // before tile 0 the prefix is 0
    unsigned long long s = idx >= 0 ? load_status(status + idx) : kFlagPrefix;
    unsigned waiting, prefix, ready;
    while (true) {
      waiting = __ballot_sync(0xffffffffu, (s >> 62) == 0);
      prefix = __ballot_sync(0xffffffffu, (s >> 62) == 2);
      ready = waiting ? (waiting & (0u - waiting)) - 1u : 0xffffffffu;
      if ((prefix & ready) || !waiting) break;  // enough is known
      if ((s >> 62) == 0) s = load_status(status + idx);
    }
    const unsigned hit = prefix & ready;
    const int upto = hit ? __ffs(hit) - 1 : 31;  // the nearest prefix, or all
    long long v = lane <= upto ? static_cast<long long>(s & kValueMask) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (hit) break;
  }
  if (lane == 0) {
    store_status(status + tile,
                 kFlagPrefix | static_cast<unsigned long long>(excl + tile_bytes));
  }
  return excl;
}

template <typename Tok>
__global__ void __launch_bounds__(kThreads)
decode_stream_kernel(const Tok* __restrict__ tokens, int head, int n,
                     const uint4* __restrict__ mat16,
                     const uint8_t* __restrict__ lens,
                     uint8_t* __restrict__ out, long long max_out,
                     long long* __restrict__ out_len,
                     unsigned long long* __restrict__ scratch, int n_tiles) {
  __shared__ uint4 image4[kImageChunks];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_tile;
  __shared__ int s_clear;
  __shared__ long long s_prefix;
  uint32_t* image = reinterpret_cast<uint32_t*>(image4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1ull));
  __syncthreads();
  const int tile = s_tile;

  // ---- tokens, lengths and rows, all loads in flight together
  const long long end = head + static_cast<long long>(n);
  const long long p0 = static_cast<long long>(tile) * kTile + tid * kItems;
  int tok[kItems];
  load_tokens(tokens, p0, end, tok);
  int len[kItems];
  uint4 row[kItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = p0 + i >= head && p0 + i < end;
    len[i] = ok ? static_cast<int>(__ldg(lens + tok[i])) : 0;
    row[i] = ok ? __ldg(mat16 + tok[i]) : make_uint4(0u, 0u, 0u, 0u);
    sum += len[i];
  }

  // ---- block scan of the threads' byte counts
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int start = incl - sum;  // the thread's first byte in the tile
  int tile_bytes = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_sums[w];
    if (w < warp) start += v;
    tile_bytes += v;
  }

  // ---- the tile's place in the output
  if (warp == 0) {
    const long long excl = look_back(scratch + 2, tile, tile_bytes);
    if (lane == 0) {
      s_prefix = excl;
      __threadfence();  // the prefix is published before the tile counts done
      const unsigned long long done = atomicAdd(scratch + 1, 1ull);
      s_clear = done == static_cast<unsigned long long>(n_tiles - 1);
      if (s_clear) __threadfence();  // every other tile's look-back is over
    }
  }
  __syncthreads();
  const long long g0 = s_prefix;
  const long long base = g0 & ~15LL;  // output byte of image byte 0

  // ---- this thread's bytes into the image, as whole words where it can
  {
    int pos = static_cast<int>(g0 - base) + start;
    const int first_word = pos >> 2;
    const int first_lo = pos & 3;  // bytes of the first word a neighbour owns
    uint32_t cur = 0;              // bytes [pos & ~3, pos) not yet stored
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int l = len[i];
      if (l == 0) continue;
      const uint32_t r0 = row[i].x & byte_mask(l);
      const uint32_t r1 = row[i].y & byte_mask(l - 4);
      const uint32_t r2 = row[i].z & byte_mask(l - 8);
      const uint32_t r3 = row[i].w & byte_mask(l - 12);
      const int sh = 8 * (pos & 3);
      const uint32_t x0 = cur | (r0 << sh);
      const uint32_t x1 = __funnelshift_l(r0, r1, sh);
      const uint32_t x2 = __funnelshift_l(r1, r2, sh);
      const uint32_t x3 = __funnelshift_l(r2, r3, sh);
      const uint32_t x4 = __funnelshift_l(r3, 0u, sh);
      const int full = ((pos & 3) + l) >> 2;  // words this token completes
      const int w0 = pos >> 2;
      if (full > 0) put_word(image, w0, x0, w0 == first_word ? first_lo : 0, 4);
      if (full > 1) image[w0 + 1] = x1;
      if (full > 2) image[w0 + 2] = x2;
      if (full > 3) image[w0 + 3] = x3;
      cur = full == 0 ? x0 : full == 1 ? x1 : full == 2 ? x2 : full == 3 ? x3 : x4;
      pos += l;
    }
    if (pos & 3) {
      put_word(image, pos >> 2, cur, (pos >> 2) == first_word ? first_lo : 0,
               pos & 3);
    }
  }
  __syncthreads();

  // ---- the image to device memory: 16-byte stores, bytes at the two ends
  const long long tile_end = g0 + tile_bytes;
  const long long g1 = tile_end < max_out ? tile_end : max_out;
  if (g0 < g1) {
    const int chunks = static_cast<int>((g1 - base + 15) >> 4);
    const uint8_t* image8 = reinterpret_cast<const uint8_t*>(image4);
    for (int c = tid; c < chunks; c += kThreads) {
      const long long q = base + 16LL * c;
      if (q >= g0 && q + 16 <= g1) {
        *reinterpret_cast<uint4*>(out + q) = image4[c];
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (q + b >= g0 && q + b < g1) out[q + b] = image8[16 * c + b];
        }
      }
    }
  }

  // ---- the last tile: out_len and the zeros up to max_out
  if (tile == n_tiles - 1) {
    if (tid == 0) *out_len = tile_end;
    if (tile_end < max_out) {
      const long long z0 = (tile_end + 15) & ~15LL;
      const long long z1 = max_out & ~15LL;
      for (long long p = tile_end + tid; p < max_out && p < z0; p += kThreads) out[p] = 0;
      for (long long q = z0 + 16LL * tid; q < z1; q += 16LL * kThreads) {
        *reinterpret_cast<uint4*>(out + q) = make_uint4(0u, 0u, 0u, 0u);
      }
      for (long long p = (z1 > z0 ? z1 : z0) + tid; p < max_out; p += kThreads) {
        out[p] = 0;
      }
    }
  }

  // ---- the last tile out of its look-back leaves the scratch zeroed
  if (s_clear) {
    for (int k = tid; k < n_tiles; k += kThreads) scratch[2 + k] = 0;
    if (tid == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

template <typename Tok>
int launch(const void* tokens, const void* mat16, const void* lens, void* out,
           void* out_len, void* scratch, long long scratch_words, int n,
           long long max_out, cudaStream_t stream) {
  const auto addr = reinterpret_cast<uintptr_t>(tokens);
  if (addr % sizeof(Tok)) return static_cast<int>(cudaErrorInvalidValue);
  const int head = static_cast<int>((addr & 15) / sizeof(Tok));
  const long long n_tiles = (head + static_cast<long long>(n) + kTile - 1) / kTile;
  if (scratch_words < n_tiles + 2 || n_tiles >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_stream_kernel<Tok><<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      reinterpret_cast<const Tok*>(addr - (addr & 15)), head, n,
      static_cast<const uint4*>(mat16), static_cast<const uint8_t*>(lens),
      static_cast<uint8_t*>(out), max_out, static_cast<long long*>(out_len),
      static_cast<unsigned long long*>(scratch), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode tokens[0, n) (uint16 when tok_bytes is 2, int32 when 4; n clamped
// to [0, T]) into out[0, max_out), with uint8 entry lengths `lens`; out_len
// receives the full decoded length (which may exceed max_out). scratch is
// int64[scratch_words], zeroed before the first call on a stream and left
// zeroed by every call; it must hold ceil((n + 16 / tok_bytes) / kTile) + 2
// words. Launches nothing when n <= 0.
extern "C" int onpair_decode_stream(const void* tokens, int tok_bytes,
                                    const void* mat16, const void* lens,
                                    void* out, void* out_len, void* scratch,
                                    long long scratch_words, int T, int n,
                                    long long max_out, void* stream) {
  n = n < 0 ? 0 : (n > T ? T : n);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tok_bytes) {
    case 2:
      return launch<uint16_t>(tokens, mat16, lens, out, out_len, scratch,
                              scratch_words, n, max_out, s);
    case 4:
      return launch<int32_t>(tokens, mat16, lens, out, out_len, scratch,
                             scratch_words, n, max_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
