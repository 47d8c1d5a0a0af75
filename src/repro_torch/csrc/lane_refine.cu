// Virtual-lane words of the subsumption lattice, refined from real-bank words.
//
// Replaces the Pallas kernel repro/kernels/triple_match.py::lane_refine_pallas
// (K7). A virtual lane v holds a pattern strictly contained by real bank lane
// parents[v]: the child equals the parent AND residual[v], the child's
// constants in exactly the slots the parent leaves variable (-1 elsewhere).
// So bit v of a row's virtual words is the parent lane's bit, read out of the
// row's real-bank words, AND the three-term residual compare. A parent of -1,
// or one outside the real words, marks a dead slot: its bit is 0. PAD rows
// need no mask of their own, since their real words are 0. Output word
// wv, bit b carries slot 32 wv + b, as int32[..., n, Wv] with Wv = max(1,
// ceil(Vp / 32)), the bits of uint32.
//
// The TPU kernel refined one [W, N] plane a call and the broker vmapped it
// over the frontier planes. Here the planes are one more grid axis: plane f
// reads words[f] and, when spo_plane_stride is 0, one row set shared by every
// plane (the delta chain's union rows) or else its own rows spo[f] (the
// stacked pass), so every plane of a fire takes one launch.
//
// Bound on an H100: memory for the broker's lattices (Vp of 32 to a few
// hundred). A row reads its three terms and its W real words once (12 + 4 W
// B) and writes its Wv virtual words once (4 Wv B); per slot ~10 integer
// operations. One thread per (plane, row); the parents and residuals are
// staged in shared memory in chunks of kStageSlots slots, the same for every
// thread, and a row's real words are held in registers when W <= kRegWords.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 16;
constexpr int kStageSlots = 32 * kStageWords;  // 512 slots, 8 KiB of shared memory
constexpr int kRegWords = 8;
constexpr int32_t kWildcard = -1;

__global__ void lane_refine_kernel(const int32_t* __restrict__ spo, int64_t spo_plane_stride,
                                   const int32_t* __restrict__ words, int64_t n, int n_words,
                                   const int32_t* __restrict__ parents,
                                   const int32_t* __restrict__ residual, int n_virt,
                                   int n_out, int32_t* __restrict__ out) {
  __shared__ int32_t par[kStageSlots];
  __shared__ int32_t res[kStageSlots * 3];
  const int64_t f = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const int32_t* wrow = words + (f * n + i) * n_words;
  int32_t s = 0, p = 0, o = 0;
  int32_t wreg[kRegWords];
#pragma unroll
  for (int k = 0; k < kRegWords; ++k) wreg[k] = 0;
  if (in_range) {
    const int32_t* row = spo + f * spo_plane_stride * 3 + 3 * i;
    s = __ldg(row);
    p = __ldg(row + 1);
    o = __ldg(row + 2);
    if (n_words <= kRegWords) {
#pragma unroll
      for (int k = 0; k < kRegWords; ++k) {
        if (k < n_words) wreg[k] = __ldg(wrow + k);
      }
    }
  }
  const int n_bits = 32 * n_words;
  for (int v0 = 0; v0 < n_out * 32; v0 += kStageSlots) {
    const int slots = max(0, min(kStageSlots, n_virt - v0));
    __syncthreads();  // the previous stage's reads are done
    for (int t = threadIdx.x; t < slots; t += blockDim.x) par[t] = parents[v0 + t];
    for (int t = threadIdx.x; t < 3 * slots; t += blockDim.x) res[t] = residual[3 * v0 + t];
    __syncthreads();
    if (!in_range) continue;
    const int stage_words = min(kStageWords, n_out - v0 / 32);
    for (int w = 0; w < stage_words; ++w) {
      uint32_t acc = 0;
      const int lo = 32 * w;
      const int hi = min(lo + 32, slots);
      for (int j = lo; j < hi; ++j) {
        const int32_t pa = par[j];
        if (pa < 0 || pa >= n_bits) continue;  // a dead slot
        const int wi = pa >> 5;
        int32_t word;
        if (n_words <= kRegWords) {
          word = wreg[0];
#pragma unroll
          for (int k = 1; k < kRegWords; ++k) {
            if (wi == k) word = wreg[k];
          }
        } else {
          word = __ldg(wrow + wi);
        }
        const int32_t rs = res[3 * j], rp = res[3 * j + 1], ro = res[3 * j + 2];
        const bool m = ((static_cast<uint32_t>(word) >> (pa & 31)) & 1u) &&
                       (rs == kWildcard || rs == s) && (rp == kWildcard || rp == p) &&
                       (ro == kWildcard || ro == o);
        acc |= static_cast<uint32_t>(m) << (j - lo);
      }
      out[(f * n + i) * n_out + v0 / 32 + w] = static_cast<int32_t>(acc);
    }
  }
}

}  // namespace

// words: int32[n_planes, n, n_words]; spo: int32[n, 3] shared by every plane
// (spo_plane_stride 0) or int32[n_planes, n, 3] (spo_plane_stride n);
// parents: int32[n_virt]; residual: int32[n_virt, 3]; n_out must be
// max(1, ceil(n_virt / 32)); out: int32[n_planes, n, n_out].
extern "C" int lane_refine_launch(const int32_t* spo, int64_t spo_plane_stride,
                                  const int32_t* words, int64_t n_planes, int64_t n, int n_words,
                                  const int32_t* parents, const int32_t* residual, int n_virt,
                                  int n_out, int32_t* out, cudaStream_t stream) {
  if (n_planes <= 0 || n <= 0) return 0;
  if (n_words < 1 || n_virt < 0 || n_out != (n_virt > 0 ? (n_virt + 31) / 32 : 1) ||
      n_planes > 65535 || (spo_plane_stride != 0 && spo_plane_stride != n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_planes));
  lane_refine_kernel<<<grid, kThreads, 0, stream>>>(spo, spo_plane_stride, words, n, n_words,
                                                    parents, residual, n_virt, n_out, out);
  return static_cast<int>(cudaGetLastError());
}
