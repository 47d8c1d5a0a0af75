// Virtual-lane words of the subsumption lattice, refined from real-bank words.
//
// Replaces the Pallas kernel repro/kernels/triple_match.py::lane_refine_pallas
// (K7). A virtual lane v holds a pattern strictly contained by real bank lane
// parents[v]: the child equals the parent AND residual[v], the child's
// constants in exactly the slots the parent leaves variable (-1 elsewhere).
// So bit v of a row's virtual words is the parent lane's bit, read out of the
// row's real-bank words, AND the three-term residual compare. A parent of -1,
// or one outside the real words, marks a dead slot: its bit is 0. Output word
// wv, bit b carries slot 32 wv + b, as int32[..., n, Wv] with Wv = max(1,
// ceil(Vp / 32)), the bits of uint32.
//
// The TPU kernel compared every slot on every row, one [W, N] plane a call.
// Here a row needs no loop over the slots. Slot v's bit is
//   parent_bit(v) AND M_s(s) AND M_p(p) AND M_o(o),
// where M_k(x) is the mask of the slots whose residual at position k is the
// wildcard or equals x: M_k(x) = wild_k OR eq_k(x). Each block builds, in
// shared memory, from parents and residual:
//   - wild_k and, per position, an open-addressing table of the distinct
//     residual constants, each with its slot mask eq_k(c) (the wildcard -1 is
//     never a key, so it marks an empty entry);
//   - the child mask C_l of every real lane l that is a live slot's parent,
//     found through the list of real words that hold such lanes: a word's
//     "has children" mask and the rank of its first lane among them.
// A row then takes three table lookups; each plane ORs C_l over the set bits
// of (real word AND has-children mask), a few bits a row at the flush, and
// stores (OR of C_l) AND M_s AND M_p AND M_o. Dead and padding slots lie in no
// C_l, so their bits come out 0; PAD rows have zero real words, so they do
// too. Slots are taken in chunks of kChunkWords output words, tables rebuilt
// a chunk, so any Vp fits the fixed shared memory.
//
// The grid is persistent (as many blocks as fit on the card, rows strided),
// so a block's table build is paid once over all its rows; the slots' and
// the first row's loads are in flight while the tables are built, and each
// later row's while the row before it is worked on. With shared rows
// (spo_plane_stride 0: the delta chain's union rows) a thread reads a row and
// looks up its masks once, then loops over the planes; with per-plane rows
// (the stacked pass) the planes are one longer run of rows.
//
// Bound on an H100: bytes. The rows once (12 B a row when shared), each
// plane's real words read (4 W B) and virtual words written (4 Wv B); the
// operations, three lookups a row, an OR a set parent bit with children and
// Wv ANDs a plane, are far below the card's int32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkWords = 4;                 // output words a pass over the rows
constexpr int kChunkSlots = 32 * kChunkWords;  // 128 virtual slots
constexpr int kMaxCap = 2 * kChunkSlots;       // table entries, load factor <= 1/2
constexpr int32_t kWildcard = -1;
constexpr int32_t kEmpty = -1;                 // the wildcard is never a key
constexpr int kPreloadPlanes = 2;              // planes whose first word a row loads ahead
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kChunkSlots <= kThreads && kChunkWords <= kThreads / 32, "warp w holds output word w's slots");

struct Tables {
  int32_t key[3][kMaxCap];                   // residual constants, per position
  uint32_t eq[3][kMaxCap * kChunkWords];     // eq_k(key): slot mask, cw words an entry
  uint32_t wild[3][kChunkWords];             // slots with a wildcard at position k
  int32_t n_const[3];
  int32_t wkey[kMaxCap];                     // real words holding a live parent
  uint32_t wbits[kMaxCap];                   // their lanes with children
  int32_t wpos[kMaxCap];                     // the word's place in the list
  int32_t lword[kChunkSlots];                // the list: word index,
  uint32_t lbits[kChunkSlots];               //   its lanes with children,
  int32_t lbase[kChunkSlots];                //   rank of its first such lane
  int32_t n_list;
  uint32_t child[kChunkSlots * kChunkWords]; // C_l by rank, cw words each
};

__device__ __forceinline__ int hash_slot(int32_t x, int mask) {
  uint32_t h = static_cast<uint32_t>(x) * 0x9E3779B1u;
  return static_cast<int>(h ^ (h >> 15)) & mask;
}

// The entry of x, inserted if new; *fresh tells whether this call inserted it.
__device__ __forceinline__ int table_insert(int32_t* keys, int mask, int32_t x, bool* fresh) {
  int h = hash_slot(x, mask);
  while (true) {
    const int32_t prev = atomicCAS(keys + h, kEmpty, x);
    if (prev == kEmpty || prev == x) {
      *fresh = prev == kEmpty;
      return h;
    }
    h = (h + 1) & mask;
  }
}

// The entry of x, or -1. x == -1 finds nothing: the probe stops at an empty entry first.
__device__ __forceinline__ int table_find(const int32_t* keys, int mask, int32_t x) {
  int h = hash_slot(x, mask);
  while (true) {
    const int32_t k = keys[h];
    if (k == kEmpty) return -1;
    if (k == x) return h;
    h = (h + 1) & mask;
  }
}

// Build the tables of slots [v0, v0 + slots), output words [w0, w0 + cw).
// Thread j < slots holds slot v0 + j: its parent par and residual res, loaded
// before the call so that those loads overlap the row loads. Warp w holds the
// slots of output word w, so a warp's ballot is that word's mask, and lanes
// that share a key (a constant, a parent lane) meet in one atomic.
__device__ void build_tables(Tables& t, int32_t par, const int32_t (&res)[3], int slots, int cw,
                             int cap, int n_bits) {
  const int mask = cap - 1;
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    t.key[0][j] = t.key[1][j] = t.key[2][j] = kEmpty;
    t.wkey[j] = kEmpty;
    t.wbits[j] = 0;
  }
  for (int j = threadIdx.x; j < 3 * cap * cw; j += blockDim.x) t.eq[j / (cap * cw)][j % (cap * cw)] = 0;
  for (int j = threadIdx.x; j < slots * cw; j += blockDim.x) t.child[j] = 0;
  if (threadIdx.x < 3) t.n_const[threadIdx.x] = 0;
  __syncthreads();
  const int j = threadIdx.x, lane = j & 31, wl = j >> 5;
  const bool live = j < slots && par >= 0 && par < n_bits;  // else a dead or padding slot
  // pass 1: wildcard and constant masks, the real words with children
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned wild = __ballot_sync(kFullWarp, live && res[k] == kWildcard);
    if (lane == 0 && wl < cw) t.wild[k][wl] = wild;
    const bool con = live && res[k] != kWildcard;
    const unsigned peers = __match_any_sync(kFullWarp, con ? res[k] : kWildcard);
    if (con && lane == __ffs(peers) - 1) {
      bool fresh;
      const int h = table_insert(t.key[k], mask, res[k], &fresh);
      if (fresh) atomicAdd(&t.n_const[k], 1);
      atomicOr(&t.eq[k][h * cw + wl], peers);
    }
  }
  // the lanes of this warp's slots with the same parent lane
  const unsigned siblings = __match_any_sync(kFullWarp, live ? par : -1);
  const bool leader = live && lane == __ffs(siblings) - 1;
  if (leader) {
    bool fresh;
    const int h = table_insert(t.wkey, mask, par >> 5, &fresh);
    atomicOr(&t.wbits[h], 1u << (par & 31));
  }
  __syncthreads();
  // the list of real words with children, and each one's first rank (warp 0)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0, base = 0;
    for (int j0 = 0; j0 < cap; j0 += 32) {
      const int j = j0 + lane;
      const bool used = j < cap && t.wkey[j] != kEmpty;
      const unsigned ballot = __ballot_sync(kFullWarp, used);
      const int pc = used ? __popc(t.wbits[j]) : 0;
      int incl = pc;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFullWarp, incl, d);
        if (lane >= d) incl += up;
      }
      if (used) {
        const int pos = count + __popc(ballot & ((1u << lane) - 1u));
        t.lword[pos] = t.wkey[j];
        t.lbits[pos] = t.wbits[j];
        t.lbase[pos] = base + incl - pc;
        t.wpos[j] = pos;
      }
      count += __popc(ballot);
      base += __shfl_sync(kFullWarp, incl, 31);
    }
    if (lane == 0) t.n_list = count;
  }
  __syncthreads();
  // pass 2: the live slots' bits into their parent's child mask
  if (leader) {
    const int e = t.wpos[table_find(t.wkey, mask, par >> 5)];
    const int b = par & 31;
    const int rank = t.lbase[e] + __popc(t.lbits[e] & ((1u << b) - 1u));
    atomicOr(&t.child[rank * cw + wl], siblings);
  }
  __syncthreads();
}

// n_rows rows (s, p, o at spo + 3 i), each with n_planes planes of words
// (plane f of row i at words + (f * plane_rows + i) * n_words) and of output
// (at out + (f * plane_rows + i) * n_out).
__global__ void __launch_bounds__(kThreads, 4)
lane_refine_kernel(const int32_t* __restrict__ spo, int64_t n_rows, int64_t n_planes,
                   int64_t plane_rows, const int32_t* __restrict__ words, int n_words,
                   const int32_t* __restrict__ parents, const int32_t* __restrict__ residual,
                   int n_virt, int n_out, int32_t* __restrict__ out) {
  __shared__ Tables t;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int n_bits = 32 * n_words;
  for (int w0 = 0; w0 < n_out; w0 += kChunkWords) {
    const int v0 = 32 * w0;
    const int slots = max(0, min(kChunkSlots, n_virt - v0));
    const int cw = min(kChunkWords, n_out - w0);
    int cap = 2;
    while (cap < 2 * slots) cap <<= 1;
    const int mask = cap - 1;
    // the slots' loads, each thread's slot of the chunk
    int32_t par = -1, res[3] = {kWildcard, kWildcard, kWildcard};
    if (threadIdx.x < slots) {
      const int64_t v = v0 + threadIdx.x;
      par = __ldg(parents + v);
      res[0] = __ldg(residual + 3 * v);
      res[1] = __ldg(residual + 3 * v + 1);
      res[2] = __ldg(residual + 3 * v + 2);
    }
    // a row's terms and the first real word of its first planes, loaded one
    // row ahead (the first row's while the tables are built)
    int64_t i = first;
    int32_t s = 0, p = 0, o = 0, wz[kPreloadPlanes] = {};
    auto load_row = [&](int64_t r) {
      s = __ldg(spo + 3 * r);
      p = __ldg(spo + 3 * r + 1);
      o = __ldg(spo + 3 * r + 2);
#pragma unroll
      for (int q = 0; q < kPreloadPlanes; ++q) {
        if (q < n_planes) wz[q] = __ldg(words + (q * plane_rows + r) * n_words);
      }
    };
    if (i < n_rows) load_row(i);
    build_tables(t, par, res, slots, cw, cap, n_bits);
    const int n_list = t.n_list;
    const bool vec4 = cw == 4 && (n_out & 3) == 0;
    const bool vec2 = cw == 2 && (n_out & 1) == 0;
    while (i < n_rows) {
      // M_s AND M_p AND M_o for this chunk's slots
      uint32_t m[kChunkWords];
#pragma unroll
      for (int w = 0; w < kChunkWords; ++w) m[w] = ~0u;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int32_t x = k == 0 ? s : (k == 1 ? p : o);
        const int h = t.n_const[k] > 0 ? table_find(t.key[k], mask, x) : -1;
#pragma unroll
        for (int w = 0; w < kChunkWords; ++w) {
          if (w < cw) m[w] &= t.wild[k][w] | (h >= 0 ? t.eq[k][h * cw + w] : 0u);
        }
      }
      bool any = false;
#pragma unroll
      for (int w = 0; w < kChunkWords; ++w) any |= w < cw && m[w] != 0;
      any &= n_list > 0;
      int32_t word0[kPreloadPlanes];
#pragma unroll
      for (int q = 0; q < kPreloadPlanes; ++q) word0[q] = wz[q];
      const int64_t next = i + stride;
      if (next < n_rows) load_row(next);  // the next row's loads fly during this row's planes
      for (int64_t f = 0; f < n_planes; ++f) {
        const int64_t row = f * plane_rows + i;
        uint32_t acc[kChunkWords];
#pragma unroll
        for (int w = 0; w < kChunkWords; ++w) acc[w] = 0;
        if (any) {  // no word is read for a row no slot's residual admits
          const int32_t* wrow = words + row * n_words;
          for (int e = 0; e < n_list; ++e) {
            const uint32_t has = t.lbits[e];
            const int wi = t.lword[e];
            int32_t word;
            if (wi == 0 && f < kPreloadPlanes) {
              word = word0[0];
#pragma unroll
              for (int q = 1; q < kPreloadPlanes; ++q) {
                if (f == q) word = word0[q];
              }
            } else {
              word = __ldg(wrow + wi);
            }
            uint32_t x = static_cast<uint32_t>(word) & has;
            while (x) {
              const int b = __ffs(x) - 1;
              x &= x - 1u;
              const uint32_t* c = t.child + (t.lbase[e] + __popc(has & ((1u << b) - 1u))) * cw;
#pragma unroll
              for (int w = 0; w < kChunkWords; ++w) {
                if (w < cw) acc[w] |= c[w];
              }
            }
          }
#pragma unroll
          for (int w = 0; w < kChunkWords; ++w) acc[w] &= m[w];
        }
        int32_t* dst = out + row * n_out + w0;
        if (vec4) {
          *reinterpret_cast<int4*>(dst) = make_int4(static_cast<int32_t>(acc[0]), static_cast<int32_t>(acc[1]),
                                                    static_cast<int32_t>(acc[2]), static_cast<int32_t>(acc[3]));
        } else if (vec2) {
          *reinterpret_cast<int2*>(dst) = make_int2(static_cast<int32_t>(acc[0]), static_cast<int32_t>(acc[1]));
        } else {
#pragma unroll
          for (int w = 0; w < kChunkWords; ++w) {
            if (w < cw) dst[w] = static_cast<int32_t>(acc[w]);
          }
        }
      }
      i = next;
    }
    __syncthreads();  // every row of this chunk is done with the tables
  }
}

int blocks_for(int64_t rows) {
  static int sm_count[64];
  static int per_sm[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sm_count[dev] == 0) {
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], lane_refine_kernel, kThreads, 0);
    if (sm_count[dev] <= 0) sm_count[dev] = 1;
    if (per_sm[dev] <= 0) per_sm[dev] = 1;
  }
  const int64_t need = (rows + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sm_count[dev]) * per_sm[dev];
  return static_cast<int>(need < most ? need : most);
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
  // per-plane rows are one run of n_planes * n rows, each with one plane
  const bool shared = spo_plane_stride == 0;
  const int64_t rows = shared ? n : n_planes * n;
  const int64_t planes = shared ? n_planes : 1;
  lane_refine_kernel<<<blocks_for(rows), kThreads, 0, stream>>>(spo, rows, planes, n, words, n_words,
                                                                parents, residual, n_virt, n_out, out);
  return static_cast<int>(cudaGetLastError());
}
