// Fused bank match + lane routing + member mask for a stacked broker cohort.
//
// Replaces the Pallas kernel
// repro/kernels/triple_match.py::triple_match_lanes_pallas (K5). For member k
// of a cohort and row i of its stacked rows spo_b[k], bit j of out[k, i] is
// set iff the row matches bank row lanes[k, j] (the bank lane that member k's
// local pattern j reads); a pattern slot of -1 is a wildcard, PAD rows give 0,
// all-PAD bank rows and lanes outside [0, n_pat) never match, and a member
// with active[k] == 0 (cohort padding) writes zeros. The words are the bits of
// uint32, stored as int32.
//
// The TPU kernel matched every row against all 32 W bank rows and routed the
// lanes afterwards. Lane L's bank bit is exactly the match against bank row
// L, so matching only the member's nt <= 32 routed rows gives the same bits
// at nt compares a row instead of 32 W.
//
// Bound on an H100: bytes. An active member's rows are read once (12 B a
// row) and every member's words written once (4 B a row); the nt compares a
// row are far below the int32 rate. So the kernel is a vectorised row stream,
// as triple_match.cu: a thread takes 4 consecutive rows of one member (48 B)
// as three 16-byte read-only loads, stores their 4 words as one 16-byte
// store, and loads its next group while it matches this one. An inactive
// member's groups take a 16-byte zero store and no load. The grid is
// persistent (as many blocks as fit); work items are (member, group of 4
// rows), member-major, strided over the grid. Each block stages the routed
// bank rows bank[lanes[k, j]] (PAD rows for lanes outside the bank) and the
// member mask of a chunk of members in shared memory once, after its first
// group's loads are already in flight. A chunk holds every member while
// R nt <= 1024; wider cohorts are staged chunk after chunk. Item indices are
// 32-bit (N < 2^32 rows a member), which keeps the loop at 56 registers.
//
// Member k's rows start at spo_b + 3 k N and its words at out + k N, so when
// N % 4 != 0 (or the base is off 16-byte alignment, as a store sliced along
// R is) each member has its own misalignment: its first rows up to a 16-byte
// boundary, and its last N - head rows past the last whole group, take a
// scalar path, and a group whose words are not 16-byte aligned stores them
// one by one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTargets = 32;
constexpr int kThreads = 256;
constexpr int kMaxSlots = 1024;  // routed bank rows staged at once: 12 KB
constexpr int kMaxChunk = 1024;  // members staged at once
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;

__device__ __forceinline__ bool matches(const int32_t* pat, int32_t s, int32_t p, int32_t o) {
  return (pat[0] == kWildcard || pat[0] == s) && (pat[1] == kWildcard || pat[1] == p) &&
         (pat[2] == kWildcard || pat[2] == o);
}

__device__ __forceinline__ int32_t match_one(const int32_t* pat, int nt, const int32_t* row) {
  const int32_t s = __ldg(row), p = __ldg(row + 1), o = __ldg(row + 2);
  uint32_t acc = 0;
  for (int j = 0; j < nt; ++j) acc |= static_cast<uint32_t>(matches(pat + 3 * j, s, p, o)) << j;
  return s == kPad ? 0 : static_cast<int32_t>(acc);
}

__device__ __forceinline__ void load_group(const int4* src, int64_t g, int32_t (&r)[12]) {
  const int4 a = __ldg(src + 3 * g), b = __ldg(src + 3 * g + 1), c = __ldg(src + 3 * g + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

// Member k's scalar head: its rows [0, head) lie before the first 16-byte
// boundary of its rows (spo_b + 3 k n is a0 + 3 k n words past one, mod 4).
__device__ __forceinline__ int64_t head_of(int a0, int64_t k, int64_t n) {
  const int64_t mis = (a0 + 3 * ((k & 3) * (n & 3))) & 3;
  return mis < n ? mis : n;
}

// Member k's body: its whole groups of 4 rows after its scalar head, and
// whether their words take 16-byte stores.
struct Group {
  const int4* src;  // the member's rows from its head on
  int32_t* dst;     // the member's words from its head on
  int groups;       // whole groups of 4 rows after the head
  bool aligned;     // dst is 16-byte aligned
};

__device__ __forceinline__ Group group_of(const int32_t* spo_b, int32_t* out, int a0, int b0, int k, int64_t n) {
  const int64_t head = head_of(a0, k, n);
  Group m;
  m.src = reinterpret_cast<const int4*>(spo_b + 3 * (k * n + head));
  m.dst = out + k * n + head;
  m.groups = static_cast<int>((n - head) >> 2);
  m.aligned = ((b0 + (k & 3) * (n & 3) + head) & 3) == 0;
  return m;
}

__global__ void __launch_bounds__(kThreads)
triple_match_lanes_kernel(const int32_t* __restrict__ spo_b, int64_t r, int64_t n,
                          const int32_t* __restrict__ bank, int n_pat,
                          const int32_t* __restrict__ lanes, int nt,
                          const int32_t* __restrict__ active, int32_t* __restrict__ out) {
  __shared__ int32_t pat[kMaxSlots * 3];
  __shared__ bool live[kMaxChunk];  // the member reads its rows: active and nt > 0
  const int a0 = static_cast<int>((reinterpret_cast<uintptr_t>(spo_b) >> 2) & 3);
  const int b0 = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  const bool scalar = a0 != 0 || (n & 3) != 0;  // some member has a head or a tail
  const int chunk = nt > 0 ? kMaxSlots / nt : kMaxChunk;
  const int gm = static_cast<int>(n >> 2);  // work items a member; its whole groups are gm or gm - 1
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  // advancing an item (k, g) by the stride: k += dk, g += dg, carrying past gm
  const int dk = gm > 0 ? stride / gm : 0, dg = gm > 0 ? stride % gm : 0;

  for (int c0 = 0; c0 < r; c0 += chunk) {
    const int c1 = c0 + chunk < r ? c0 + chunk : static_cast<int>(r);
    int k = c0, g = 0;
    if (gm > 0) {
      k = c0 + tid / gm;
      g = tid % gm;
    }
    // the first group's loads fly while the routed rows are staged
    Group m = group_of(spo_b, out, a0, b0, k, n);
    int32_t rows[12] = {};
    if (gm > 0 && k < c1 && nt > 0 && __ldg(active + k) != 0 && g < m.groups) load_group(m.src, g, rows);
    const int slots = (c1 - c0) * nt;
    for (int t = threadIdx.x; t < slots; t += blockDim.x) {
      const int32_t lane = __ldg(lanes + static_cast<int64_t>(c0) * nt + t);
      const bool inside = lane >= 0 && lane < n_pat;
      pat[3 * t] = inside ? __ldg(bank + 3 * lane) : kPad;
      pat[3 * t + 1] = inside ? __ldg(bank + 3 * lane + 1) : kPad;
      pat[3 * t + 2] = inside ? __ldg(bank + 3 * lane + 2) : kPad;
    }
    for (int t = threadIdx.x; t < c1 - c0; t += blockDim.x) live[t] = nt > 0 && __ldg(active + c0 + t) != 0;
    __syncthreads();

    if (scalar) {  // up to 3 head and 3 tail rows a member
      for (int t = tid; t < 6 * (c1 - c0); t += stride) {
        const int km = c0 + t / 6, slot = t % 6;
        const int64_t head = head_of(a0, km, n);
        const int64_t i = slot < 3 ? slot : head + 4 * ((n - head) >> 2) + (slot - 3);
        if (slot < 3 ? i < head : i < n) {
          const int64_t row = km * n + i;
          out[row] = live[km - c0] ? match_one(pat + 3 * (km - c0) * nt, nt, spo_b + 3 * row) : 0;
        }
      }
    }
    while (gm > 0 && k < c1) {
      int32_t cur[12];
#pragma unroll
      for (int q = 0; q < 12; ++q) cur[q] = rows[q];
      const Group here = m;
      const bool on = live[k - c0];
      const int32_t* pk = pat + 3 * (k - c0) * nt;
      const int gk = g;
      k += dk;
      g += dg;
      if (g >= gm) {
        g -= gm;
        ++k;
      }
      if (k < c1) {  // the next group flies meanwhile
        m = group_of(spo_b, out, a0, b0, k, n);
        if (live[k - c0] && g < m.groups) load_group(m.src, g, rows);
      }
      if (gk >= here.groups) continue;  // the item past a member's last whole group
      int32_t w[4] = {};
      if (on) {
        uint32_t acc[4] = {};
        for (int j = 0; j < nt; ++j) {
          const int32_t* pj = pk + 3 * j;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q] |= static_cast<uint32_t>(matches(pj, cur[3 * q], cur[3 * q + 1], cur[3 * q + 2])) << j;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = cur[3 * q] == kPad ? 0 : static_cast<int32_t>(acc[q]);
      }
      if (here.aligned) {
        *reinterpret_cast<int4*>(here.dst + 4 * gk) = make_int4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) here.dst[4 * gk + q] = w[q];
      }
    }
    if (c1 < r) __syncthreads();  // every thread is done with this chunk's rows
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
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], triple_match_lanes_kernel, kThreads, 0);
    if (sm_count[dev] <= 0) sm_count[dev] = 1;
    if (per_sm[dev] <= 0) per_sm[dev] = 1;
  }
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sm_count[dev]) * per_sm[dev];
  return static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
}

}  // namespace

// spo_b: int32[r, n, 3]; bank: int32[n_pat, 3]; lanes: int32[r, nt];
// active: int32[r]; out: int32[r, n].
extern "C" int triple_match_lanes_launch(const int32_t* spo_b, int64_t r, int64_t n,
                                         const int32_t* bank, int n_pat, const int32_t* lanes,
                                         int nt, const int32_t* active, int32_t* out,
                                         cudaStream_t stream) {
  if (r <= 0 || n <= 0) return 0;
  // item indices are 32-bit: a member's groups, and a group index plus the stride, fit
  if (nt < 0 || nt > kMaxTargets || r > 65535 || n >= (int64_t{1} << 32) || n_pat < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a thread a group of 4 rows, at most one wave; at least a thread for each
  // of a member's head and tail rows
  const int64_t work = r * (n / 4 + 6);
  triple_match_lanes_kernel<<<blocks_for(work), kThreads, 0, stream>>>(spo_b, r, n, bank, n_pat, lanes, nt,
                                                                        active, out);
  return static_cast<int>(cudaGetLastError());
}
