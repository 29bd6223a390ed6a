// decode_compact for Hopper (sm_90a): OnPair16 random-access decode of M
// strings (paper Algorithm 3), a group of lanes per string, over ragged rows.
//
// Replaces the Pallas TPU kernel `decode_compact` (body `_compact_kernel`)
// in src/repro/kernels/onpair_decode.py. One kernel serves both callers:
//   * the store's multiget: row m is string ids[m] of a token buffer that
//     stays on the device (the sealed segments' u16 payload), its tokens
//     [starts[id], starts[id + 1]), written to [out_start[m], out_start[m+1])
//     of one packed output; the host ships ids and output offsets only;
//   * the padded contract of decode_compact: int32 tokens [B, T], row b at
//     starts[b] = b*T with n_tokens[b] tokens, output row b at b*(16T + 16).
//
// What bounds it on this card: latency, not bandwidth. A 1,024-id multiget
// moves about 144 KB (ids and offsets, the strings' starts, about 5k u16
// tokens, their distinct 16-byte rows and lengths, about 43 KB out): about
// 0.04 us at 3.35 TB/s. Its time is launch latency plus one row's chain of
// dependent loads: id -> start -> tokens -> (row, length) -> stores.
//
// Design: a group of kGroup = 8 lanes decodes one string; a block of 128
// threads holds 16 strings, so 1,024 strings fill 64 blocks. Strings average
// 4.87 tokens on book titles and most have at most 8 (the store's smallest
// length bucket), so most strings take one round of the group; a whole warp
// per string would leave most of its lanes idle. Each lane loads one token,
// then its length and its 16-byte dictionary row (one `uint4` load) in
// parallel; a `__shfl_up_sync` scan of the lengths across the group gives
// each lane its start, and longer strings loop in rounds of 8 tokens,
// carrying the offset. So a string costs one chain of dependent loads per 8
// tokens, where one thread per string paid one per token.
//
// Output: Algorithm 3's unconditional 16-byte store at the cursor is safe
// only inside a padded row or a sequential loop: in a packed output the
// last store of row m runs into row m+1, which another group writes at the
// same time. Here each lane writes only its token's bytes, j < len, and no
// byte at or past out_start[m+1], even under a malformed length table
// (lengths are clamped to [0, 16] as they are read). out_len[m] is the sum
// of the clamped lengths, the true decoded length, so a caller can catch a
// row whose range was too short. The stores are byte stores: the lanes of a
// group write one contiguous run, and the whole output of a multiget is
// about 43 KB (13 ns of HBM time), so staging it in shared memory to write
// 16-byte words would add a barrier and a pass to the chain for nothing
// the times could show. Tokens at or past the buffer's end, tokens at or
// past the dictionary's size, and row ids outside [0, n_starts - 1) decode
// to nothing (no out-of-bounds read).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;      // lanes per string
constexpr int kThreads = 128;  // threads per block
constexpr int kRowsPerBlock = kThreads / kGroup;

template <typename TokT>
__global__ void __launch_bounds__(kThreads)
decode_rows_kernel(const TokT* __restrict__ tokens, long long n_tok_total,
                   const long long* __restrict__ starts, long long n_starts,
                   const long long* __restrict__ ids,      // null: row m is string m
                   const int32_t* __restrict__ counts,     // null: from starts
                   int max_count,
                   const long long* __restrict__ out_start,
                   const uint8_t* __restrict__ mat16,
                   const int32_t* __restrict__ lens, int n_entries,
                   uint8_t* __restrict__ out, long long out_size,
                   int32_t* __restrict__ out_len, int M) {
  const int lane = threadIdx.x & (kGroup - 1);
  const long long m = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / kGroup;
  if (m >= M) return;  // a group shares m: it leaves whole
  const unsigned gmask = ((1u << kGroup) - 1u)
                         << ((threadIdx.x & 31) & ~(kGroup - 1));
  const long long id = ids != nullptr ? ids[m] : m;
  long long s = 0, n = 0;  // an id with no string decodes to nothing
  if (ids == nullptr || (id >= 0 && id + 1 < n_starts)) {
    s = starts[id];
    n = counts != nullptr ? counts[m] : starts[id + 1] - s;
  }
  n = n < 0 ? 0 : (n > max_count ? max_count : n);
  const long long base = out_start[m];
  long long room = out_start[m + 1] - base;  // bytes this row may write
  if (base < 0 || base > out_size) room = 0;
  if (room > out_size - base) room = out_size - base;
  uint8_t* dst = out + base;
  const uint4* rows = reinterpret_cast<const uint4*>(mat16);
  long long carry = 0;
  for (long long r = 0; r < n; r += kGroup) {
    const long long k = s + r + lane;
    int len = 0;
    uint4 row = make_uint4(0u, 0u, 0u, 0u);
    if (r + lane < n && k >= 0 && k < n_tok_total) {
      const long long t = static_cast<long long>(tokens[k]);
      if (t >= 0 && t < n_entries) {
        len = __ldg(lens + t);
        len = len < 0 ? 0 : (len > 16 ? 16 : len);
        row = __ldg(rows + t);
      }
    }
    int inc = len;
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1) {
      const int u = __shfl_up_sync(gmask, inc, d, kGroup);
      if (lane >= d) inc += u;
    }
    const int total = __shfl_sync(gmask, inc, kGroup - 1, kGroup);
    const long long pos = carry + inc - len;
    const uint32_t words[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < len && pos + j < room) {
        dst[pos + j] = static_cast<uint8_t>(words[j >> 2] >> (8 * (j & 3)));
      }
    }
    carry += total;
  }
  if (lane == 0) out_len[m] = static_cast<int32_t>(carry);
}

template <typename TokT>
void launch(const void* tokens, long long n_tok_total, const void* starts,
            long long n_starts, const void* ids, const void* counts, int max_count,
            const void* out_start, const void* mat16, const void* lens,
            int n_entries, void* out, long long out_size, void* out_len, int M,
            cudaStream_t stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  decode_rows_kernel<TokT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TokT*>(tokens), n_tok_total,
      static_cast<const long long*>(starts), n_starts,
      static_cast<const long long*>(ids),
      static_cast<const int32_t*>(counts), max_count,
      static_cast<const long long*>(out_start),
      static_cast<const uint8_t*>(mat16), static_cast<const int32_t*>(lens),
      n_entries, static_cast<uint8_t*>(out), out_size,
      static_cast<int32_t*>(out_len), M);
}

}  // namespace

// Decode M rows (see above). tok_bytes is 2 (uint16 tokens) or 4 (int32);
// starts holds n_starts entries; ids and counts may be null (with ids null,
// row m reads starts[m], and starts[m + 1] too when counts is null); counts
// are clamped to [0, max_count]. No byte
// is written outside out[0, out_size), whatever out_start holds. Launches
// nothing when M <= 0. Returns cudaGetLastError().
extern "C" int onpair_decode_rows(const void* tokens, int tok_bytes,
                                  long long n_tok_total, const void* starts,
                                  long long n_starts, const void* ids, const void* counts,
                                  int max_count, const void* out_start,
                                  const void* mat16, const void* lens,
                                  int n_entries, void* out, long long out_size,
                                  void* out_len, int M, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tok_bytes == 2) {
    launch<uint16_t>(tokens, n_tok_total, starts, n_starts, ids, counts, max_count,
                     out_start, mat16, lens, n_entries, out, out_size, out_len,
                     M, s);
  } else if (tok_bytes == 4) {
    launch<int32_t>(tokens, n_tok_total, starts, n_starts, ids, counts, max_count,
                    out_start, mat16, lens, n_entries, out, out_size, out_len,
                    M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* onpair_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
