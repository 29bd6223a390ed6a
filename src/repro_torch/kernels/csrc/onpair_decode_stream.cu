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
// What bounds it on this card: bytes. The call must read 4 bytes per token
// and write each decoded byte once (about 4.3 decoded bytes per token byte
// read on book titles); the dictionary (at most 1 MiB of rows and 256 KiB of
// lengths) stays in the 50 MB L2 after first touch. There is no arithmetic
// to speak of.
//
// Design: three passes over tiles of kTile tokens, one token per thread.
//   1. tile_sums: each block sums the lengths of its tile's valid tokens.
//   2. scan_tiles: one block turns the tile sums into each tile's exclusive
//      start (int64, carried across chunks of blockDim tiles) and writes
//      out_len, the total.
//   3. scatter: each block scans its lengths again, so each token has its
//      start inside the tile, and copies exactly `len` bytes of its 16-byte
//      row (one uint4 load) into a shared-memory image of the tile's output.
//      The block then writes that image to [tile start, tile start + tile
//      sum) with consecutive threads on consecutive bytes, dropping bytes at
//      or past max_out. Tiles own disjoint output ranges, so no two threads
//      ever store the same byte: unlike decode_compact's unconditional
//      16-byte store, no token overwrites its neighbour's bytes. The last
//      block also zeroes [out_len, max_out), as the reference's zero-filled
//      output has it.
// Starts and out_len are int64, so a stream past 2 GiB does not wrap.
// Tokens at or past n (clamped to [0, T]) decode to nothing; only tiles
// holding valid tokens are launched.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // tokens per block = threads per block
constexpr int kWarps = kTile / 32;

// Inclusive scan of one value per thread across a block of kTile threads.
// `warp_sums` is shared scratch of kWarps entries; the block's total comes
// back in `total`. Ends with the scratch free for reuse.
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = warp_sums[lane];  // kWarps == 32: one entry per lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kTile)
decode_stream_tile_sums(const int32_t* __restrict__ tokens,
                        const int32_t* __restrict__ lens,
                        long long* __restrict__ tile_sums, int n) {
  __shared__ int warp_sums[kWarps];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const int len = i < n ? __ldg(lens + tokens[i]) : 0;
  int total;
  block_inclusive_scan(len, warp_sums, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kTile)
decode_stream_scan_tiles(long long* __restrict__ tile_sums, int n_tiles,
                         long long* __restrict__ out_len) {
  __shared__ long long warp_sums[kWarps];
  long long carry = 0;
  for (int base = 0; base < n_tiles; base += kTile) {
    const int i = base + threadIdx.x;
    const long long v = i < n_tiles ? tile_sums[i] : 0;
    long long total;
    const long long inc = block_inclusive_scan(v, warp_sums, &total);
    if (i < n_tiles) tile_sums[i] = carry + inc - v;  // exclusive start
    carry += total;
  }
  if (threadIdx.x == 0) *out_len = carry;
}

__global__ void __launch_bounds__(kTile)
decode_stream_scatter(const int32_t* __restrict__ tokens,
                      const uint8_t* __restrict__ mat16,
                      const int32_t* __restrict__ lens,
                      const long long* __restrict__ tile_starts,
                      const long long* __restrict__ out_len,
                      uint8_t* __restrict__ out, int n, long long max_out) {
  __shared__ uint8_t image[kTile * 16];
  __shared__ int warp_sums[kWarps];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  int tok = 0;
  int len = 0;
  if (i < n) {
    tok = tokens[i];
    len = __ldg(lens + tok);
  }
  int tile_bytes;
  const int local = block_inclusive_scan(len, warp_sums, &tile_bytes) - len;
  if (len > 0) {
    const uint4 row = __ldg(reinterpret_cast<const uint4*>(mat16) + tok);
    const uint32_t words[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < len) {
        image[local + j] = static_cast<uint8_t>(words[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
  __syncthreads();
  const long long start = tile_starts[blockIdx.x];
  long long room = max_out - start;
  const int limit = room < tile_bytes ? (room > 0 ? static_cast<int>(room) : 0)
                                      : tile_bytes;
  for (int k = threadIdx.x; k < limit; k += kTile) out[start + k] = image[k];
  if (blockIdx.x == gridDim.x - 1) {
    for (long long p = *out_len + threadIdx.x; p < max_out; p += kTile) out[p] = 0;
  }
}

}  // namespace

// Decode tokens[0, n) (n clamped to [0, T]) into out[0, max_out); out_len
// receives the full decoded length (which may exceed max_out). tile_sums is
// int64 scratch of ceil(n / 1024) entries. Launches nothing when n <= 0.
extern "C" int onpair_decode_stream(const void* tokens, const void* mat16,
                                    const void* lens, void* out, void* out_len,
                                    void* tile_sums, int T, int n,
                                    long long max_out, void* stream) {
  n = n < 0 ? 0 : (n > T ? T : n);
  if (n == 0) return 0;
  const int n_tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sums = static_cast<long long*>(tile_sums);
  auto* total = static_cast<long long*>(out_len);
  decode_stream_tile_sums<<<n_tiles, kTile, 0, s>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(lens),
      sums, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_stream_scan_tiles<<<1, kTile, 0, s>>>(sums, n_tiles, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_stream_scatter<<<n_tiles, kTile, 0, s>>>(
      static_cast<const int32_t*>(tokens), static_cast<const uint8_t*>(mat16),
      static_cast<const int32_t*>(lens), sums, total,
      static_cast<uint8_t*>(out), n, max_out);
  return static_cast<int>(cudaGetLastError());
}
