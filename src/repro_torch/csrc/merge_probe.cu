// Lexicographic probe of a sorted triple store: searchsorted over (s, p, o) rows.
//
// Replaces the Pallas kernels repro/kernels/merge_join.py::merge_probe_pallas
// (K2) and ::merge_probe_windowed (K3), and serves the port's
// triples.searchsorted_rows (member, prefix_range and so difference,
// intersection and the evaluator's probes). For each query row q it returns
// the left insertion point (first row >= q) and whether that row equals q, or
// under side=right the right insertion point (first row > q). Queries keep
// their order; nothing is sorted or windowed first.
//
// Bound on an H100: dependent loads. One thread runs one global binary search
// of ceil(log2(C + 1)) steps, each a 12-byte load that depends on the last;
// the top levels of the search tree are shared by all queries and stay in the
// 50 MB L2, the bottom levels are scattered reads. A global search has no
// skewed-block case, so the TPU kernels' 2048-row windows and the host-side
// skew check are dropped. Staging the top of the tree in shared memory is
// left to a later kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool lex_less(int32_t as, int32_t ap, int32_t ao, int32_t bs,
                                         int32_t bp, int32_t bo) {
  return as < bs || (as == bs && (ap < bp || (ap == bp && ao < bo)));
}

template <bool kRight>
__global__ void merge_probe_kernel(const int32_t* __restrict__ store, int64_t c,
                                   const int32_t* __restrict__ queries, int64_t q,
                                   int32_t* __restrict__ idx, uint8_t* __restrict__ found) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int32_t qs = __ldg(queries + 3 * i);
  const int32_t qp = __ldg(queries + 3 * i + 1);
  const int32_t qo = __ldg(queries + 3 * i + 2);
  int64_t lo = 0, hi = c;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t rs = __ldg(store + 3 * mid);
    const int32_t rp = __ldg(store + 3 * mid + 1);
    const int32_t ro = __ldg(store + 3 * mid + 2);
    const bool go_right =
        kRight ? !lex_less(qs, qp, qo, rs, rp, ro) : lex_less(rs, rp, ro, qs, qp, qo);
    if (go_right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  idx[i] = static_cast<int32_t>(lo);
  if (!kRight) {
    bool hit = false;
    if (lo < c) {
      hit = __ldg(store + 3 * lo) == qs && __ldg(store + 3 * lo + 1) == qp &&
            __ldg(store + 3 * lo + 2) == qo;
    }
    found[i] = hit ? 1 : 0;
  }
}

}  // namespace

// side: 0 = left (writes idx and found), 1 = right (writes idx; found may be null).
extern "C" int merge_probe_launch(const int32_t* store, int64_t c, const int32_t* queries,
                                  int64_t q, int side, int32_t* idx, uint8_t* found,
                                  cudaStream_t stream) {
  if (q <= 0) return 0;
  if (side != 0 && side != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (side == 0 && found == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((q + kThreads - 1) / kThreads);
  if (side == 0) {
    merge_probe_kernel<false><<<blocks, kThreads, 0, stream>>>(store, c, queries, q, idx, found);
  } else {
    merge_probe_kernel<true><<<blocks, kThreads, 0, stream>>>(store, c, queries, q, idx, found);
  }
  return static_cast<int>(cudaGetLastError());
}
