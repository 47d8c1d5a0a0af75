// Bank words as per-position slot masks over a vectorised row stream.
//
// The device code of the two bank-words kernels, triple_match_words.cu (K4)
// and triple_match_words_segmented.cu (K6). K4 is K6 with every row a member
// and one plane. Word w of a valid row has bit j set iff the row matches bank
// row 32 w + j, -1 being a wildcard; PAD rows (s == INT32_MAX) give 0. In K6
// plane f holds those words for the rows whose seg bit f is set and 0 for the
// others; seg bits at or above n_seg are ignored. Output int32[n_planes, n, W]
// row-major, the words being the bits of uint32.
//
// No loop over the bank rows: the match is per position, so a row's word is
//   (wild_s | eq_s(s)) & (wild_p | eq_p(p)) & (wild_o | eq_o(o)),
// where wild_k is the mask of the slots with the wildcard at position k and
// eq_k(x) the mask of those with the constant x there. Each block builds, in
// shared memory, wild_k and per position an open-addressing table of the
// slots' distinct constants, each entry the key beside its slot mask, so that
// one vector load reads both (-1 is never a key, so it marks an empty entry;
// a lookup of -1 finds nothing, as a wildcard-free slot never matches a term
// of -1). A row then takes three lookups, each one shared load unless the
// probe meets another key first. A bank row whose s is PAD never meets a valid row, so padding and
// tombstones (all-PAD rows) are left out of every table; rows PAD at other
// positions only are kept, PAD being a constant like any other there. Slots
// go in chunks of up to kChunkWords output words, the tables rebuilt a chunk,
// so any W fits fixed shared memory.
//
// The rows stream 4 a thread: three 16-byte read-only loads for the 4 rows'
// terms (and, in K6, one for their 4 seg words), the next group's loads in
// flight while this one is matched, and 16-byte stores of the group's words
// (per plane in K6). The grid is persistent (as many blocks as fit, groups
// strided), so a block builds its tables once for all its rows; the first
// group's loads are issued before the build's barriers. A base off 16-byte
// alignment (the broker hands in sliced stores) takes its first rows, and
// N % 4 its last ones, on a scalar path; seg loads and output stores fall
// back to scalar ones where their address is off alignment.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkWords = 4;                 // output words a pass over the rows
constexpr int kChunkSlots = 32 * kChunkWords;  // 128 bank rows
constexpr int kMaxCap = 2 * kChunkSlots;       // table entries a position, load factor <= 1/2
constexpr int32_t kPad = 0x7fffffff;
constexpr int32_t kWildcard = -1;
constexpr int32_t kEmpty = -1;                 // the wildcard is never a key
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kChunkSlots <= kThreads, "a thread a slot of the chunk");

// Words of a table entry: the key, then its slot mask's kCW words, padded to
// a vector width so that one shared load reads them together.
constexpr int entry_words(int cw) { return cw == 1 ? 2 : (cw <= 3 ? 4 : 8); }

template <int kCW>
struct Tables {
  static constexpr int kStride = entry_words(kCW);
  // per position: open addressing over the slots' constants, each entry the
  // key and eq_k(key); an empty entry has the key -1 and an all-zero mask
  alignas(16) int32_t entry[3][kMaxCap * kStride];
  uint32_t wild[3][kCW];  // slots with the wildcard at position k
  int32_t has[3];         // position k has a constant
};

// Fibonacci hashing: the top log2(cap) bits of x * 2^32 / phi.
__device__ __forceinline__ int hash_slot(int32_t x, int shift) {
  return static_cast<int>((static_cast<uint32_t>(x) * 0x9E3779B9u) >> shift);
}

template <int kCW>
__device__ __forceinline__ void read_entry(const int32_t* e, int32_t& key, uint32_t (&eq)[kCW]) {
  if constexpr (kCW == 1) {
    const int2 v = *reinterpret_cast<const int2*>(e);
    key = v.x;
    eq[0] = v.y;
  } else {
    const int4 v = *reinterpret_cast<const int4*>(e);
    key = v.x;
    eq[0] = v.y;
    eq[1] = v.z;
    if constexpr (kCW >= 3) eq[2] = v.w;
    if constexpr (kCW == 4) eq[3] = e[4];
  }
}

// Build the tables of one chunk of cap entries a position (cap = 2^(32 -
// shift)). Thread j holds the chunk's slot j, its bank row pat (loaded before
// the call, so that the load overlaps the rows'), live unless j is past the
// chunk or the row's s is PAD. Warp w holds output word w's slots, so a warp's
// ballot is that word's wildcard mask, and lanes that share a constant meet in
// one insert and one atomic.
template <int kCW>
__device__ __forceinline__ void build_tables(Tables<kCW>& t, const int32_t (&pat)[3], bool live, int cap,
                                             int shift) {
  constexpr int kS = Tables<kCW>::kStride;
  const int mask = cap - 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int j = threadIdx.x; j < cap * kS; j += blockDim.x) t.entry[k][j] = (j & (kS - 1)) == 0 ? kEmpty : 0;
  }
  if (threadIdx.x < 3) t.has[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned wild = __ballot_sync(kFullWarp, live && pat[k] == kWildcard);
    if (lane == 0 && wl < kCW) t.wild[k][wl] = wild;
    const bool con = live && pat[k] != kWildcard;
    const unsigned peers = __match_any_sync(kFullWarp, con ? pat[k] : kWildcard);
    if (con && lane == __ffs(peers) - 1) {
      int h = hash_slot(pat[k], shift);
      while (true) {  // the entry of pat[k], inserted if new
        const int32_t prev = atomicCAS(&t.entry[k][h * kS], kEmpty, pat[k]);
        if (prev == kEmpty || prev == pat[k]) break;
        h = (h + 1) & mask;
      }
      atomicOr(reinterpret_cast<uint32_t*>(&t.entry[k][h * kS + 1 + wl]), peers);
      t.has[k] = 1;
    }
  }
  __syncthreads();
}

// What a row reads of a chunk's tables besides the entries, kept in registers.
template <int kCW>
struct Masks {
  int mask, shift;
  bool lookup[3];  // the position has a constant
  uint32_t wild[3][kCW];
};

// The chunk's words of the row (s, p, o): 0 for a PAD row. A lookup reads its
// first entry in one shared load and probes on only past another key; it
// ends on the term's entry or an empty one, whose mask is 0 (so a term of -1,
// never a key, finds nothing).
template <int kCW>
__device__ __forceinline__ void match_row(const Tables<kCW>& t, const Masks<kCW>& c, int32_t s, int32_t p, int32_t o,
                                          uint32_t (&m)[kCW]) {
  constexpr int kS = Tables<kCW>::kStride;
#pragma unroll
  for (int w = 0; w < kCW; ++w) m[w] = s == kPad ? 0u : ~0u;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int32_t x = k == 0 ? s : (k == 1 ? p : o);
    uint32_t eq[kCW] = {};
    if (c.lookup[k]) {
      int h = hash_slot(x, c.shift);
      int32_t key;
      read_entry<kCW>(&t.entry[k][h * kS], key, eq);
      while (key != x && key != kEmpty) {
        h = (h + 1) & c.mask;
        read_entry<kCW>(&t.entry[k][h * kS], key, eq);
      }
    }
#pragma unroll
    for (int w = 0; w < kCW; ++w) m[w] &= c.wild[k][w] | eq[w];
  }
}

__device__ __forceinline__ void load_group(const int4* src, int64_t g, int32_t (&r)[12]) {
  const int4 a = __ldg(src + 3 * g), b = __ldg(src + 3 * g + 1), c = __ldg(src + 3 * g + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

__device__ __forceinline__ void load_seg(const int32_t* seg, bool vec, int64_t g, uint32_t keep,
                                         uint32_t (&member)[4]) {
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(seg) + g);
    member[0] = v.x; member[1] = v.y; member[2] = v.z; member[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) member[q] = __ldg(seg + 4 * g + q);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) member[q] &= keep;
}

// One pass over the rows for output words [w0, w0 + cw), cw <= kCW; cw ==
// kCW except in the last chunk of a bank wider than kChunkWords words.
template <bool kSeg, int kCW>
__device__ __forceinline__ void chunk_pass(Tables<kCW>& t, const int32_t* __restrict__ spo, const int32_t* __restrict__ seg,
                                           int64_t n, const int32_t* __restrict__ bank, int n_pat, int n_words,
                                           int w0, int cw, int n_planes, int32_t* __restrict__ out) {
  const int slots = max(0, min(32 * cw, n_pat - 32 * w0));
  int cap = 2, shift = 31;
  while (cap < 2 * slots) cap <<= 1, --shift;
  int32_t pat[3] = {kPad, kPad, kPad};
  if (threadIdx.x < slots) {
    const int32_t* b = bank + 3 * (32 * w0 + threadIdx.x);
    pat[0] = __ldg(b);
    pat[1] = __ldg(b + 1);
    pat[2] = __ldg(b + 2);
  }
  // rows [0, head) and [body_end, n) are scalar; spo + 3 head is 16-byte aligned
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(spo) >> 2) & 3);
  const int64_t head = mis < n ? mis : n;
  const int64_t groups = (n - head) / 4;
  const int64_t body_end = head + 4 * groups;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* src = reinterpret_cast<const int4*>(spo + 3 * head);
  const int planes = kSeg ? n_planes : 1;
  const uint32_t keep = planes >= 32 ? ~0u : (1u << planes) - 1u;
  const int32_t* seg_body = nullptr;
  bool seg_vec = false;
  if constexpr (kSeg) {
    seg_body = seg + head;
    seg_vec = (reinterpret_cast<uintptr_t>(seg_body) & 15) == 0;
  }
  // the first group's loads fly while the tables are built
  int32_t r[12] = {};
  uint32_t member[4] = {1u, 1u, 1u, 1u};
  if (tid < groups) {
    load_group(src, tid, r);
    if constexpr (kSeg) load_seg(seg_body, seg_vec, tid, keep, member);
  }
  build_tables<kCW>(t, pat, threadIdx.x < slots && pat[0] != kPad, cap, shift);
  Masks<kCW> c;
  c.mask = cap - 1;
  c.shift = shift;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.lookup[k] = t.has[k] != 0;
#pragma unroll
    for (int w = 0; w < kCW; ++w) c.wild[k][w] = t.wild[k][w];
  }
  const int64_t plane = n * n_words;

  // the scalar head and tail rows
  if (tid < head + (n - body_end)) {
    const int64_t i = tid < head ? tid : body_end + (tid - head);
    uint32_t m[kCW];
    match_row(t, c, __ldg(spo + 3 * i), __ldg(spo + 3 * i + 1), __ldg(spo + 3 * i + 2), m);
    uint32_t in = 1u;
    if constexpr (kSeg) in = static_cast<uint32_t>(__ldg(seg + i)) & keep;
    for (int f = 0; f < planes; ++f) {
      int32_t* dst = out + f * plane + i * n_words + w0;
      const bool on = (in >> f) & 1u;
#pragma unroll
      for (int w = 0; w < kCW; ++w) {
        if (w < cw) dst[w] = on ? static_cast<int32_t>(m[w]) : 0;
      }
    }
  }

  // the body: 4 rows a thread, the next group in flight
  const bool whole = kCW == n_words;  // a group's words are 4 kCW consecutive words
  for (int64_t g = tid; g < groups; g += stride) {
    int32_t cur[12];
    uint32_t cur_member[4];
#pragma unroll
    for (int k = 0; k < 12; ++k) cur[k] = r[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) cur_member[q] = member[q];
    if (g + stride < groups) {
      load_group(src, g + stride, r);
      if constexpr (kSeg) load_seg(seg_body, seg_vec, g + stride, keep, member);
    }
    uint32_t m[4][kCW];
#pragma unroll
    for (int q = 0; q < 4; ++q) match_row(t, c, cur[3 * q], cur[3 * q + 1], cur[3 * q + 2], m[q]);
    for (int f = 0; f < planes; ++f) {
      int32_t v[4 * kCW];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool on = (cur_member[q] >> f) & 1u;
#pragma unroll
        for (int w = 0; w < kCW; ++w) v[q * kCW + w] = on ? static_cast<int32_t>(m[q][w]) : 0;
      }
      int32_t* dst = out + f * plane + (head + 4 * g) * n_words + w0;
      const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
      if (whole && aligned) {
#pragma unroll
        for (int e = 0; e < kCW; ++e) {
          reinterpret_cast<int4*>(dst)[e] = make_int4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 0; w < kCW; ++w) {
            if (w < cw) dst[q * n_words + w] = v[q * kCW + w];
          }
        }
      }
    }
  }
  __syncthreads();  // every row of this chunk is done with the tables
}

// spo: int32[n, 3]; seg: int32[n] (K6) or null (K4); bank: int32[n_pat, 3];
// out: int32[n_planes, n, n_words]. Chunks of kCW output words.
template <bool kSeg, int kCW>
__global__ void __launch_bounds__(kThreads)
bank_words_kernel(const int32_t* __restrict__ spo, const int32_t* __restrict__ seg, int64_t n,
                  const int32_t* __restrict__ bank, int n_pat, int n_words, int n_planes,
                  int32_t* __restrict__ out) {
  __shared__ Tables<kCW> t;
  for (int w0 = 0; w0 < n_words; w0 += kCW) {
    chunk_pass<kSeg, kCW>(t, spo, seg, n, bank, n_pat, n_words, w0, min(kCW, n_words - w0), n_planes, out);
  }
}

template <bool kSeg, int kCW>
int launch_chunks(const int32_t* spo, const int32_t* seg, int64_t n, const int32_t* bank, int n_pat, int n_words,
                  int n_planes, int32_t* out, cudaStream_t stream) {
  static int sm_count[64];
  static int per_sm[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sm_count[dev] == 0) {
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], bank_words_kernel<kSeg, kCW>, kThreads, 0);
    if (sm_count[dev] <= 0) sm_count[dev] = 1;
    if (per_sm[dev] <= 0) per_sm[dev] = 1;
  }
  // a thread a group of 4 rows, at most one wave; at least the head and tail rows' 6 threads
  const int64_t need = (n / 4 + 6 + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sm_count[dev]) * per_sm[dev];
  const int blocks = static_cast<int>(need < most ? need : most);
  bank_words_kernel<kSeg, kCW><<<blocks, kThreads, 0, stream>>>(spo, seg, n, bank, n_pat, n_words, n_planes, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel for a bank of n_words words, in chunks of min(n_words, kChunkWords) words.
template <bool kSeg>
int launch_bank_words(const int32_t* spo, const int32_t* seg, int64_t n, const int32_t* bank, int n_pat,
                      int n_words, int n_planes, int32_t* out, cudaStream_t stream) {
  switch (n_words < kChunkWords ? n_words : kChunkWords) {
    case 1: return launch_chunks<kSeg, 1>(spo, seg, n, bank, n_pat, n_words, n_planes, out, stream);
    case 2: return launch_chunks<kSeg, 2>(spo, seg, n, bank, n_pat, n_words, n_planes, out, stream);
    case 3: return launch_chunks<kSeg, 3>(spo, seg, n, bank, n_pat, n_words, n_planes, out, stream);
    default: return launch_chunks<kSeg, kChunkWords>(spo, seg, n, bank, n_pat, n_words, n_planes, out, stream);
  }
}

}  // namespace
