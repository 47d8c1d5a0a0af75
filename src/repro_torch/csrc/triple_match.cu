// Multi-pattern triple match: the bitset of patterns each triple row matches.
//
// Replaces the Pallas kernel repro/kernels/triple_match.py::triple_match_pallas
// (K1). Bit j of out[i] is set iff row i matches patterns[j]; a pattern slot of
// -1 is a wildcard and PAD rows (s == INT32_MAX) match nothing. The words are
// the bits of uint32, stored as int32.
//
// Bound on an H100: bytes. Each row is read once (12 B) and its word written
// once (4 B); the <= 32 x 3 compares a row are below the card's int32 rate.
// So the kernel is a vectorised row stream: a thread takes 4 consecutive rows
// (48 B) as three 16-byte read-only loads and stores their 4 words as one
// 16-byte store, and loads its next group while it matches this one. The
// grid is persistent (as many blocks as fit, groups strided), so each block
// stages the pattern table in shared memory once, while its first groups'
// loads are already in flight. A base pointer that is not 16-byte
// aligned (a sliced store can start on any 4-byte boundary) takes its first
// rows, and N % 4 != 0 its last ones, on a scalar path; the body's stores
// fall back to scalar ones when the output is not 16-byte aligned there. The
// TPU tiling ((N/128, 128) blocks of 32 rows) is not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPatterns = 32;
constexpr int kThreads = 256;
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__device__ __forceinline__ bool matches(const int32_t* pat, int32_t s, int32_t p, int32_t o) {
  return (pat[0] == kWildcard || pat[0] == s) && (pat[1] == kWildcard || pat[1] == p) &&
         (pat[2] == kWildcard || pat[2] == o);
}

__device__ __forceinline__ int32_t match_one(const int32_t* pat, int n_pat, const int32_t* row) {
  const int32_t s = __ldg(row), p = __ldg(row + 1), o = __ldg(row + 2);
  uint32_t acc = 0;
  for (int j = 0; j < n_pat; ++j) acc |= static_cast<uint32_t>(matches(pat + 3 * j, s, p, o)) << j;
  return s == kPad ? 0 : static_cast<int32_t>(acc);
}

__device__ __forceinline__ void load_group(const int4* src, int64_t g, int32_t (&r)[12]) {
  const int4 a = __ldg(src + 3 * g), b = __ldg(src + 3 * g + 1), c = __ldg(src + 3 * g + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

__global__ void __launch_bounds__(kThreads)
triple_match_kernel(const int32_t* __restrict__ spo, int64_t n, const int32_t* __restrict__ patterns,
                    int n_pat, int32_t* __restrict__ out) {
  __shared__ int32_t pat[kMaxPatterns * 3];
  // rows [0, head) and [head + 4 groups, n) are scalar; spo + 3 head is 16-byte aligned
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(spo) >> 2) & 3);
  const int64_t head = mis < n ? mis : n;
  const int64_t groups = (n - head) / 4;
  const int64_t body_end = head + 4 * groups;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* src = reinterpret_cast<const int4*>(spo + 3 * head);
  // the first group's loads fly while the patterns are staged
  int32_t r[12] = {};
  if (tid < groups) load_group(src, tid, r);
  for (int t = threadIdx.x; t < n_pat * 3; t += blockDim.x) pat[t] = patterns[t];
  __syncthreads();

  if (tid < head) {
    out[tid] = match_one(pat, n_pat, spo + 3 * tid);
  } else if (tid < head + (n - body_end)) {
    const int64_t i = body_end + (tid - head);
    out[i] = match_one(pat, n_pat, spo + 3 * i);
  }
  int32_t* dst = out + head;
  const bool dst_aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int64_t g = tid; g < groups; g += stride) {
    int32_t cur[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) cur[k] = r[k];
    if (g + stride < groups) load_group(src, g + stride, r);  // the next group flies meanwhile
    uint32_t acc[4] = {};
    for (int j = 0; j < n_pat; ++j) {
      const int32_t* pj = pat + 3 * j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] |= static_cast<uint32_t>(matches(pj, cur[3 * q], cur[3 * q + 1], cur[3 * q + 2])) << j;
      }
    }
    int32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = cur[3 * q] == kPad ? 0 : static_cast<int32_t>(acc[q]);
    if (dst_aligned) {
      *reinterpret_cast<int4*>(dst + 4 * g) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[4 * g + q] = w[q];
    }
  }
}

int blocks_for(int64_t work) {
  static int sm_count[64];
  static int per_sm[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sm_count[dev] == 0) {
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], triple_match_kernel, kThreads, 0);
    if (sm_count[dev] <= 0) sm_count[dev] = 1;
    if (per_sm[dev] <= 0) per_sm[dev] = 1;
  }
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sm_count[dev]) * per_sm[dev];
  return static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
}

}  // namespace

extern "C" int triple_match_launch(const int32_t* spo, int64_t n, const int32_t* patterns,
                                   int n_pat, int32_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pat < 0 || n_pat > kMaxPatterns) return static_cast<int>(cudaErrorInvalidValue);
  // a thread a group of 4 rows, at most one wave; at least the head and tail rows' 6 threads
  const int64_t work = n / 4 + 6;
  triple_match_kernel<<<blocks_for(work), kThreads, 0, stream>>>(spo, n, patterns, n_pat, out);
  return static_cast<int>(cudaGetLastError());
}
