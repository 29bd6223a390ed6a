// decode_compact for Hopper (sm_90a): OnPair16 random-access decode of a
// batch of strings, paper Algorithm 3.
//
// Replaces the Pallas TPU kernel `decode_compact` (body `_compact_kernel`)
// in src/repro/kernels/onpair_decode.py.
//
// What bounds it on this card: latency, not bandwidth. The bytes the call
// must move are small (the int32 token matrix, the 16-byte dictionary rows it
// touches, the decoded bytes: a few hundred KB for the store's 256-string
// batches, about a tenth of a microsecond of HBM time at 3.35 TB/s). Each
// string is a dependent chain per token: token load -> row load -> stores ->
// length load -> next position; and a batch of 256 strings fills 8 warps of
// a 132-SM card.
//
// Design: one thread per string; the grid covers the batch, 128 threads a
// block. The dictionary stays u8[N, 16] in global memory (at most 1 MiB, so
// it lives in the 50 MB L2 after first touch) and each row is one 16-byte
// `uint4` load. Every token stores its full row at the output cursor without
// a length check and the cursor then advances by the token's true length, so
// the next token overwrites the padding. The output is u8 of width 16T + 16,
// so the last unconditional store stays in bounds; destinations are
// unaligned, so the row goes out as byte stores. Bytes past out_len are
// unspecified. A later PR can spread a string over a warp and stage rows in
// shared memory; this one is the simple, right version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void decode_compact_kernel(const int32_t* __restrict__ tokens,
                                      const int32_t* __restrict__ n_tokens,
                                      const uint8_t* __restrict__ mat16,
                                      const int32_t* __restrict__ lens,
                                      uint8_t* __restrict__ out,
                                      int32_t* __restrict__ out_len,
                                      int B, int T, int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* toks = tokens + static_cast<size_t>(b) * T;
  uint8_t* dst = out + static_cast<size_t>(b) * W;
  int n = n_tokens[b];
  n = n < 0 ? 0 : (n > T ? T : n);
  const uint4* rows = reinterpret_cast<const uint4*>(mat16);
  int pos = 0;
  // pos + 16 <= W always holds for entries of at most 16 bytes; the guard
  // keeps a malformed length table from writing past the row.
  for (int t = 0; t < n && pos <= W - 16; ++t) {
    const int tok = toks[t];
    const uint4 row = __ldg(rows + tok);
    const uint32_t words[4] = {row.x, row.y, row.z, row.w};
    uint8_t* d = dst + pos;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      d[j] = static_cast<uint8_t>(words[j >> 2] >> (8 * (j & 3)));
    }
    pos += __ldg(lens + tok);
  }
  out_len[b] = pos;
}

}  // namespace

extern "C" int onpair_decode_compact(const void* tokens, const void* n_tokens,
                                     const void* mat16, const void* lens,
                                     void* out, void* out_len, int B, int T,
                                     int W, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  decode_compact_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(n_tokens),
      static_cast<const uint8_t*>(mat16), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), B, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* onpair_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
