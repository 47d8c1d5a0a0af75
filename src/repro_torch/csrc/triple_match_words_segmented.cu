// Segment-masked bank bitset: every bank word of every row, matched once and
// stored to each segment's plane.
//
// Replaces the Pallas kernel
// repro/kernels/triple_match.py::triple_match_words_segmented_pallas (K6).
// The broker's delta frontier chain hands it the distinct-row union of the
// deleted sides of several fired frontiers and a per-row membership bitmap
// seg (bit f set iff the row is in frontier f). Plane f of the output holds,
// for a row in segment f, the row's bank words (word w, bit j set iff the row
// matches bank[32 w + j]; -1 is a wildcard, PAD rows give 0, all-PAD bank
// rows never match) and 0 for a row outside it. Bits of seg at or above
// n_seg are ignored. The words are the bits of uint32 stored as int32, laid
// out row-major as int32[n_seg, n, W]: plane f is the [n, W] slice the broker
// hands to frontier f's members, with no transpose after it.
//
// Bound on an H100: memory. Each row is read once with its seg word (16 B)
// and each plane's words written once (4 n_seg W B a row); the compares, ~7
// integer operations per valid row and live bank row, are done once per row,
// not once per plane. So the design is K4's (triple_match_words.cu): one
// thread per row, the bank staged in shared memory in chunks of kStageWords
// words, one word accumulated in a register; that word is then stored to each
// of the n_seg planes, masked by the row's membership bit. The TPU kernel's
// tiles of 32 x 128 rows and its 4096-row padding are not carried over: any n
// is taken.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 16;  // 512 bank rows, 6 KiB of shared memory
constexpr int kMaxSegments = 32;
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__global__ void triple_match_words_segmented_kernel(const int32_t* __restrict__ spo,
                                                    const int32_t* __restrict__ seg, int64_t n,
                                                    const int32_t* __restrict__ bank, int n_pat,
                                                    int n_words, int n_seg,
                                                    int32_t* __restrict__ out) {
  __shared__ int32_t pat[kStageWords * 32 * 3];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  int32_t s = kPad, p = kPad, o = kPad;
  uint32_t member = 0;
  if (in_range) {
    s = __ldg(spo + 3 * i);
    p = __ldg(spo + 3 * i + 1);
    o = __ldg(spo + 3 * i + 2);
    member = static_cast<uint32_t>(__ldg(seg + i));
  }
  const bool valid = in_range && s != kPad;
  const int64_t plane = n * n_words;
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
      if (valid && member != 0) {
        const int lo = 32 * w;
        const int hi = min(lo + 32, rows);
        for (int j = lo; j < hi; ++j) {
          const int32_t ps = pat[3 * j], pp = pat[3 * j + 1], po = pat[3 * j + 2];
          const bool m = (ps == kWildcard || ps == s) && (pp == kWildcard || pp == p) &&
                         (po == kWildcard || po == o);
          acc |= static_cast<uint32_t>(m) << (j - lo);
        }
      }
      int32_t* dst = out + i * n_words + w0 + w;
      for (int f = 0; f < n_seg; ++f) {
        dst[f * plane] = ((member >> f) & 1u) ? static_cast<int32_t>(acc) : 0;
      }
    }
  }
}

}  // namespace

// spo: int32[n, 3]; seg: int32[n]; bank: int32[n_pat, 3]; n_words must be
// max(1, ceil(n_pat / 32)) and 1 <= n_seg <= 32; out: int32[n_seg, n, n_words].
extern "C" int triple_match_words_segmented_launch(const int32_t* spo, const int32_t* seg,
                                                   int64_t n, const int32_t* bank, int n_pat,
                                                   int n_words, int n_seg, int32_t* out,
                                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pat < 0 || n_words != (n_pat > 0 ? (n_pat + 31) / 32 : 1) || n_seg < 1 ||
      n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  triple_match_words_segmented_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      spo, seg, n, bank, n_pat, n_words, n_seg, out);
  return static_cast<int>(cudaGetLastError());
}
