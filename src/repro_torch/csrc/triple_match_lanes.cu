// Fused bank match + lane routing + member mask for a stacked broker cohort.
//
// Replaces the Pallas kernel
// repro/kernels/triple_match.py::triple_match_lanes_pallas (K5). For member k
// of a cohort and row i of its stacked rows spo_b[k], bit j of out[k, i] is
// set iff the row matches bank row lanes[k, j] (the bank lane that member k's
// local pattern j reads); a pattern slot of -1 is a wildcard, PAD rows give 0,
// all-PAD bank rows never match, and a member with active[k] == 0 (cohort
// padding) writes zeros. The words are the bits of uint32, stored as int32.
//
// The TPU kernel matched every row against all 32 W bank rows and routed the
// lanes afterwards. Lane L's bank bit is exactly the match against bank row
// L, so matching only the member's nt <= 32 routed rows gives the same bits
// at nt compares a row instead of 32 W. Bound on an H100: memory. An active
// member's rows are read once (12 B a row) and every member's words written
// once (4 B a row); an inactive member reads no rows. Grid: (row blocks,
// member); each CTA gathers its member's routed bank rows into shared memory,
// then each thread matches one row and stores its word. Lanes are checked on
// the host when the cohort's statics are built; a lane outside the bank
// still reads nothing here and matches nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTargets = 32;
constexpr int kThreads = 256;
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__global__ void triple_match_lanes_kernel(const int32_t* __restrict__ spo_b, int64_t n,
                                          const int32_t* __restrict__ bank, int n_pat,
                                          const int32_t* __restrict__ lanes, int nt,
                                          const int32_t* __restrict__ active,
                                          int32_t* __restrict__ out) {
  __shared__ int32_t pat[kMaxTargets * 3];
  const int64_t k = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (active[k] == 0) {
    if (i < n) out[k * n + i] = 0;
    return;
  }
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int32_t lane = lanes[k * nt + t];
    const bool inside = lane >= 0 && lane < n_pat;
    pat[3 * t] = inside ? bank[3 * lane] : kPad;
    pat[3 * t + 1] = inside ? bank[3 * lane + 1] : kPad;
    pat[3 * t + 2] = inside ? bank[3 * lane + 2] : kPad;
  }
  __syncthreads();
  if (i >= n) return;
  const int32_t* row = spo_b + 3 * (k * n + i);
  const int32_t s = __ldg(row), p = __ldg(row + 1), o = __ldg(row + 2);
  uint32_t acc = 0;
  if (s != kPad) {
    for (int j = 0; j < nt; ++j) {
      const int32_t ps = pat[3 * j], pp = pat[3 * j + 1], po = pat[3 * j + 2];
      const bool m = (ps == kWildcard || ps == s) && (pp == kWildcard || pp == p) &&
                     (po == kWildcard || po == o);
      acc |= static_cast<uint32_t>(m) << j;
    }
  }
  out[k * n + i] = static_cast<int32_t>(acc);
}

}  // namespace

// spo_b: int32[r, n, 3]; bank: int32[n_pat, 3]; lanes: int32[r, nt];
// active: int32[r]; out: int32[r, n].
extern "C" int triple_match_lanes_launch(const int32_t* spo_b, int64_t r, int64_t n,
                                         const int32_t* bank, int n_pat, const int32_t* lanes,
                                         int nt, const int32_t* active, int32_t* out,
                                         cudaStream_t stream) {
  if (r <= 0 || n <= 0) return 0;
  if (nt < 0 || nt > kMaxTargets || r > 65535 || n_pat < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(r));
  triple_match_lanes_kernel<<<grid, kThreads, 0, stream>>>(spo_b, n, bank, n_pat, lanes, nt,
                                                           active, out);
  return static_cast<int>(cudaGetLastError());
}
