// Multi-word bank bitset: every bank word of every triple row in one pass.
//
// Replaces the Pallas kernel
// repro/kernels/triple_match.py::triple_match_words_pallas (K4). Word w of row
// i carries bit j set iff row i matches bank[32 w + j]; a pattern slot of -1 is
// a wildcard, PAD rows (s == INT32_MAX) give 0, and all-PAD bank rows (padding
// and tombstoned lanes) never match a valid row. The words are the bits of
// uint32, stored as int32, row-major int32[N, W] (the layout the ops layer
// hands out, so no transpose follows).
//
// Bound on an H100: memory for the broker's banks (W of 1-4 words). Each row
// is read once (12 B) and its W words written once (4 W B); the compares,
// ~7 integer operations per row and bank row, reach the card's integer rate
// only for banks of hundreds of words. So the design streams rows: one thread
// per row over the row-major store, the bank staged in shared memory in
// chunks of kStageWords words (a larger bank loops over chunks), one word
// accumulated in a register at a time and stored when its 32 rows are done.
// The TPU tiling ((N/128, 128) blocks of 32 rows, 4096-row padding) is not
// carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 16;  // 512 bank rows, 6 KiB of shared memory
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__global__ void triple_match_words_kernel(const int32_t* __restrict__ spo, int64_t n,
                                          const int32_t* __restrict__ bank, int n_pat,
                                          int n_words, int32_t* __restrict__ out) {
  __shared__ int32_t pat[kStageWords * 32 * 3];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  int32_t s = kPad, p = kPad, o = kPad;
  if (in_range) {
    s = __ldg(spo + 3 * i);
    p = __ldg(spo + 3 * i + 1);
    o = __ldg(spo + 3 * i + 2);
  }
  const bool valid = in_range && s != kPad;
  for (int w0 = 0; w0 < n_words; w0 += kStageWords) {
    const int stage_words = min(kStageWords, n_words - w0);
    const int first = 32 * w0;
    const int rows = max(0, min(32 * stage_words, n_pat - first));
    __syncthreads();  // the previous stage's reads are done
    for (int t = threadIdx.x; t < rows * 3; t += blockDim.x) pat[t] = bank[3 * first + t];
    __syncthreads();
    if (!in_range) continue;
    for (int w = 0; w < stage_words; ++w) {
      uint32_t acc = 0;
      if (valid) {
        const int lo = 32 * w;
        const int hi = min(lo + 32, rows);
        for (int j = lo; j < hi; ++j) {
          const int32_t ps = pat[3 * j], pp = pat[3 * j + 1], po = pat[3 * j + 2];
          const bool m = (ps == kWildcard || ps == s) && (pp == kWildcard || pp == p) &&
                         (po == kWildcard || po == o);
          acc |= static_cast<uint32_t>(m) << (j - lo);
        }
      }
      out[i * n_words + w0 + w] = static_cast<int32_t>(acc);
    }
  }
}

}  // namespace

// n_words must be max(1, ceil(n_pat / 32)); out is int32[n, n_words].
extern "C" int triple_match_words_launch(const int32_t* spo, int64_t n, const int32_t* bank,
                                         int n_pat, int n_words, int32_t* out,
                                         cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pat < 0 || n_words != (n_pat > 0 ? (n_pat + 31) / 32 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  triple_match_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      spo, n, bank, n_pat, n_words, out);
  return static_cast<int>(cudaGetLastError());
}
