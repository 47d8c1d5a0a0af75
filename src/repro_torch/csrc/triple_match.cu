// Multi-pattern triple match: the bitset of patterns each triple row matches.
//
// Replaces the Pallas kernel repro/kernels/triple_match.py::triple_match_pallas
// (K1). Bit j of out[i] is set iff row i matches patterns[j]; a pattern slot of
// -1 is a wildcard and PAD rows (s == INT32_MAX) match nothing. The words are
// the bits of uint32, stored as int32.
//
// Bound on an H100: memory. Each row is read once (12 B) and its word written
// once (4 B); the <= 32 x 3 compares per row are far below the card's integer
// rate. So the design streams rows: one thread per row over the row-major
// int32[N, 3] store (a warp reads 384 contiguous bytes, so the three loads of a
// warp share the same cache lines), the patterns sit in shared memory, loaded
// once per block, and the word is built in a register and stored once. The TPU
// tiling ((N/128, 128) blocks of 32 rows) is not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPatterns = 32;
constexpr int kThreads = 256;
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__global__ void triple_match_kernel(const int32_t* __restrict__ spo, int64_t n,
                                    const int32_t* __restrict__ patterns,
                                    int n_pat, int32_t* __restrict__ out) {
  __shared__ int32_t pat[kMaxPatterns * 3];
  for (int t = threadIdx.x; t < n_pat * 3; t += blockDim.x) pat[t] = patterns[t];
  __syncthreads();

  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = __ldg(spo + 3 * i);
  const int32_t p = __ldg(spo + 3 * i + 1);
  const int32_t o = __ldg(spo + 3 * i + 2);
  uint32_t acc = 0;
  if (s != kPad) {
    for (int j = 0; j < n_pat; ++j) {
      const int32_t ps = pat[3 * j], pp = pat[3 * j + 1], po = pat[3 * j + 2];
      const bool m = (ps == kWildcard || ps == s) && (pp == kWildcard || pp == p) &&
                     (po == kWildcard || po == o);
      acc |= static_cast<uint32_t>(m) << j;
    }
  }
  out[i] = static_cast<int32_t>(acc);
}

}  // namespace

extern "C" int triple_match_launch(const int32_t* spo, int64_t n, const int32_t* patterns,
                                   int n_pat, int32_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pat < 0 || n_pat > kMaxPatterns) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  triple_match_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(spo, n, patterns,
                                                                           n_pat, out);
  return static_cast<int>(cudaGetLastError());
}
