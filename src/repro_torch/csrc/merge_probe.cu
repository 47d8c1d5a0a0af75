// Lexicographic probe of a sorted triple store: searchsorted over (s, p, o) rows.
//
// Replaces the Pallas kernels repro/kernels/merge_join.py::merge_probe_pallas
// (K2, :81, pallas_call at :99) and ::merge_probe_windowed (K3, :131,
// pallas_call at :164), and serves the port's triples.searchsorted_rows,
// member and prefix_range (so difference, intersection, the frontier chain's
// membership and the evaluator's candidate probes). For each query row q of a
// lex-sorted, PAD-tailed int32[S, 3] store it returns, in the queries' own
// order:
//   left:  the first row >= q, and whether that row equals q;
//   right: the first row > q;
//   range: for two query sequences lo and hi, left of lo[i] and right of
//          hi[i] in one launch (prefix_range's [start, end)).
// A PAD query is "found" when the store has a PAD tail, as in the oracle.
//
// Bound on an H100, at the two main-path shapes:
// - member shape (difference(tau, r'): 8.4 M sorted queries, more than half
//   of them tau's PAD tail, into a 2^18-row store): bytes. The queries
//   (12 B) are read once and idx + found (5 B) written once, ~142 MB, 0.043
//   ms at 3.35 TB/s; a tile of 1024 sorted queries touches a few dozen store
//   rows.
// - prefix shape (prefix_range over tau by subject: 2^19 sorted queries, most
//   of them PAD, into a 2^23-row store): load latency. The real queries are
//   few, and each needs the rows around its answer out of a window far
//   larger than shared memory: the time is the chain of dependent loads of
//   the slowest tile.
// A global binary search (this kernel's first version) paid ceil(log2(S+1))
// dependent loads a query at both shapes, the upper levels shared by all
// queries and served from the caches.
//
// Design: persistent blocks (as many as fit on the SMs: 4 an SM with one
// query sequence, 54 KB of shared memory and at most 64 registers a thread;
// 2 in range mode), each walking tiles of kTile queries. A tile comes into
// shared memory by a TMA bulk copy (cp.async.bulk, completing on an
// mbarrier) into a ring of kQBufs buffers: the block's next two tiles load
// while this one is searched. A block that takes more than one tile first
// stages kSplitRows evenly spaced rows of the whole store (the block
// splitters): one round of loads, which later tiles' searches start from.
// Per tile:
// 1. Sortedness: every thread compares its queries with their predecessors
//    in shared memory; __syncthreads_and combines the results.
// 2. A sorted tile's store window: the block searches the first and last
//    query of each sequence at once, kThreads / 2 (range mode: / 4) threads
//    an end, each round comparing one pivot a thread (a 128-ary or 64-ary
//    search whose ballots are summed in shared memory), from the splitters'
//    span when they are staged. Every answer of the tile lies in [w0, w1].
//    A tile of equal queries (tau's PAD tail) searches its query once; a
//    block reuses the answer for its next tiles of the same rows.
// 3. Paths, counted per tile in the optional int32[3] tile_counts:
//    [0] window: a sorted tile whose rows [w0, w1] fit in kWindowRows, and
//        every tile of equal queries. The rows come in by one bulk copy (or
//        are the block splitters, for a store of at most kSplitRows rows);
//        every query is a binary search in shared memory.
//    [1] oversized: a sorted tile whose window does not fit. kWindowRows
//        evenly spaced rows of [w0, w1] are staged as splitters; a query
//        searches them in shared memory, then the rest of its span (at most
//        ceil((w1 - w0) / kWindowRows) rows) in global memory.
//    [2] unsorted: the same two-level search over [0, S) from the block
//        splitters, or a global search over [0, S) when they are not staged.
//    Each thread runs its kPer (two sequences: 2 kPer) searches in lockstep,
//    so their loads are in flight together. Left-side found comes from the
//    compares that set each search's upper bound.
// 4. Answers are staged in the tile's own query buffer (its queries are in
//    registers by then) and written by TMA bulk stores.
// No path sorts anything, and none falls back: every tile takes one of the
// three. Positions are uint32 and addresses 64-bit, so any store below 2^31
// rows is safe.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;                  // queries a tile
constexpr int kPer = kTile / kThreads;       // queries a thread, per sequence
constexpr int kWindowRows = 1024;            // W_max: store rows of the window path
constexpr int kQBufs = 3;                    // query tiles in flight a block: this one and the next two
constexpr int kSplitRows = 512;              // block splitters of [0, S)
constexpr int kQBytes = kTile * 12 + 16;     // one sequence's tile, aligned down to 16 B
constexpr int kWBytes = kWindowRows * 12 + 32;

enum Mode { kLeft = 0, kRight = 1, kRange = 2 };

struct Row {
  int32_t s, p, o;
};

__device__ __forceinline__ bool lex_less(const Row& a, const Row& b) {
  return a.s < b.s || (a.s == b.s && (a.p < b.p || (a.p == b.p && a.o < b.o)));
}

__device__ __forceinline__ bool row_eq(const Row& a, const Row& b) {
  return a.s == b.s && a.p == b.p && a.o == b.o;
}

// true when the answer lies right of row r: r < q (left side), r <= q (right)
__device__ __forceinline__ bool goes_right(bool right, const Row& r, const Row& q) {
  return right ? !lex_less(q, r) : lex_less(r, q);
}

// positions are uint32 (a store holds fewer than 2^31 rows); addresses are 64-bit
__device__ __forceinline__ Row ldg_row(const int32_t* __restrict__ rows, uint32_t i) {
  const int32_t* r = rows + 3 * static_cast<size_t>(i);
  return Row{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

__device__ __forceinline__ Row smem_row(const int32_t* rows, uint32_t i) {
  return Row{rows[3 * i], rows[3 * i + 1], rows[3 * i + 2]};
}

// ---- TMA bulk copies and mbarriers ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, completing on bar; dst, src and bytes multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global in the thread's bulk group; dst, src and bytes multiples of 16
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }
// orders this thread's generic-proxy shared-memory accesses before later
// bulk copies (async proxy) of the same bytes
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The 16-byte granules that hold rows [r0, r0 + n) of a row-major
// int32[., 3] array, for one bulk copy; off is the int32 offset of row r0 in
// the copy.
struct Span {
  const void* src;
  uint32_t bytes;
  int off;
};

__device__ __forceinline__ Span row_span(const int32_t* rows, int64_t r0, int64_t n) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(rows + 3 * r0);
  const uintptr_t a0 = b & ~uintptr_t(15);
  const uintptr_t a1 = (b + 12 * n + 15) & ~uintptr_t(15);
  return Span{reinterpret_cast<const void*>(a0), static_cast<uint32_t>(a1 - a0), static_cast<int>((b - a0) / 4)};
}

// shared -> global, the 16-byte part by bulk store, the tail by this thread
__device__ __forceinline__ void store_out(void* dst, const void* src, int bytes) {
  const int body = bytes & ~15;
  if (body) bulk_store(dst, src, body);
  for (int b = body; b < bytes; ++b)
    static_cast<unsigned char*>(dst)[b] = static_cast<const unsigned char*>(src)[b];
}

// ---- searches -----------------------------------------------------------------

// m evenly spaced rows of the positions [base, base + n): splitter j is row
// base + j * n / m (every row when m == n).
struct Splitters {
  const int32_t* rows;  // shared memory, int32[m, 3]
  int m;
  uint32_t base, n;

  __device__ __forceinline__ uint32_t pos(int j) const {
    return base + static_cast<uint32_t>(static_cast<uint64_t>(j) * n / m);
  }

  // Counts the c splitters that the answer lies right of; the answer is in
  // [lo, hi], and hi is splitter c's position when c < m. Returns c.
  __device__ __forceinline__ int bounds(bool right, const Row& q, uint32_t& lo, uint32_t& hi) const {
    int a = 0, b = m;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (goes_right(right, smem_row(rows, mid), q)) a = mid + 1; else b = mid;
    }
    lo = a == 0 ? base : pos(a - 1) + 1;
    hi = a == m ? base + n : pos(a);
    return a;
  }
};

// kN lockstep binary searches, each answer in [lo[k], hi[k]] and left in
// lo[k]; query k searches the right side when right(k). Each round issues
// the loads of every query before the first compare, so a thread has kN rows
// in flight. With kFound, eq[k] becomes whether the row at hi[k] equals q[k]
// whenever a compare sets hi[k] (known[k] then holds).
template <int kN, bool kFound, class Right, class Fetch>
__device__ __forceinline__ void lockstep_search(uint32_t (&lo)[kN], uint32_t (&hi)[kN], const Row (&q)[kN],
                                                bool (&eq)[kN], bool (&known)[kN], Right right, Fetch fetch) {
  while (true) {
    Row r[kN];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (lo[k] < hi[k]) {
        r[k] = fetch(lo[k] + ((hi[k] - lo[k]) >> 1));
        any = true;
      }
    }
    if (!any) break;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (lo[k] < hi[k]) {
        const uint32_t mid = lo[k] + ((hi[k] - lo[k]) >> 1);
        if (goes_right(right(k), r[k], q[k])) {
          lo[k] = mid + 1;
        } else {
          hi[k] = mid;
          if (kFound) {
            eq[k] = row_eq(r[k], q[k]);
            known[k] = true;
          }
        }
      }
    }
  }
}

// The block's search of kEnds queries at once (a sorted tile's first and
// last query of each sequence, end e = 2 s + last): kThreads / kEnds threads
// an end, each round comparing one pivot a thread, kP - 1 pivots that cut an
// end's span into kP parts; the per-warp ballots are summed in shared
// memory. The splitters (none when spl.m == 0) give each end's first span.
// With may_stop, the search stops early once the spans prove that the
// window [w0, w1] holds more than kWindowRows rows (the last ends' lower
// bounds lie that far past the first ends' upper bounds). Thread j of end e
// returns end e's
// answer, or, after an early stop, the bound of its span that makes the
// ends a window holding [w0, w1]: lo for a first end, hi for a last.
template <int kEnds>
__device__ __forceinline__ uint32_t block_search(const int32_t* __restrict__ store, const Splitters& spl,
                                                 bool right, const Row& q, bool may_stop, int* counts,
                                                 uint32_t* spans) {
  constexpr int kP = kThreads / kEnds;
  constexpr int kWarps = kP / 32;  // warps an end
  const int tid = threadIdx.x;
  const int j = tid % kP;
  const int e = tid / kP;
  uint32_t lo, hi;
  spl.bounds(right, q, lo, hi);
  while (true) {
    bool g = false;
    if (lo < hi && j < kP - 1)
      g = goes_right(right, ldg_row(store, lo + static_cast<uint32_t>(static_cast<uint64_t>(hi - lo) * (j + 1) / kP)), q);
    const unsigned bal = __ballot_sync(0xffffffffu, g);
    if ((tid & 31) == 0) counts[tid >> 5] = __popc(bal);
    if (!__syncthreads_or(lo < hi)) break;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += counts[e * kWarps + w];
    if (lo < hi) {
      const uint32_t n = hi - lo;
      const uint32_t base = lo;
      if (c > 0) lo = base + static_cast<uint32_t>(static_cast<uint64_t>(n) * c / kP) + 1;
      if (c < kP - 1) hi = base + static_cast<uint32_t>(static_cast<uint64_t>(n) * (c + 1) / kP);
    }
    if (j == 0) {
      spans[2 * e] = lo;
      spans[2 * e + 1] = hi;
    }
    __syncthreads();  // the spans are read, and the counts written again next round
    uint32_t first_hi = 0xffffffffu, last_lo = 0;
#pragma unroll
    for (int f = 0; f < kEnds; f += 2) {
      first_hi = spans[2 * f + 1] < first_hi ? spans[2 * f + 1] : first_hi;
      last_lo = spans[2 * f + 2] > last_lo ? spans[2 * f + 2] : last_lo;
    }
    if (may_stop && last_lo > first_hi && last_lo - first_hi > static_cast<uint32_t>(kWindowRows))
      return (e & 1) ? hi : lo;
    __syncthreads();  // every thread has read the spans
  }
  return lo;
}

template <int kMode>
__host__ __device__ constexpr int seqs() {
  return kMode == kRange ? 2 : 1;
}

// the answers are staged in the tile's own query buffer, once its queries
// are read: idx (or start), then found (uint8) or end (int32)
static_assert(4 * kTile + kTile <= kQBytes, "left-side answers fit a query buffer");

template <int kMode>
__host__ __device__ constexpr int smem_bytes() {
  return kQBufs * seqs<kMode>() * kQBytes + kWBytes + kSplitRows * 12;
}

// blocks an SM that the registers must allow: 4 for one query sequence
// (54 KB of shared memory a block), 2 in range mode (90 KB)
template <int kMode>
__host__ __device__ constexpr int min_blocks() {
  return kMode == kRange ? 2 : 4;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, min_blocks<kMode>())
    merge_probe_kernel(const int32_t* __restrict__ store, uint32_t s_rows, const int32_t* __restrict__ q0,
                       const int32_t* __restrict__ q1, int64_t q_rows, int32_t* __restrict__ out0,
                       void* __restrict__ out1, int32_t* __restrict__ tile_counts) {
  constexpr int kSeq = seqs<kMode>();
  constexpr int kN = kSeq * kPer;
  constexpr bool kFound = kMode == kLeft;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qbuf = smem;  // [kQBufs buffers][kSeq][kQBytes]
  int32_t* win = reinterpret_cast<int32_t*>(smem + kQBufs * kSeq * kQBytes);
  int32_t* bspl = reinterpret_cast<int32_t*>(smem + kQBufs * kSeq * kQBytes + kWBytes);
  __shared__ __align__(8) uint64_t bars[kQBufs + 1];  // the query buffers, then the window
  __shared__ uint32_t ends[kSeq][2];         // block search: answer of each sequence's first, last query
  __shared__ int woff_s;                     // int32 offset of the window's first row in win
  // the last tile of equal queries this block answered: its rows and answers
  __shared__ Row memo_q[kSeq];
  __shared__ uint32_t memo_pos[kSeq];
  __shared__ int memo_found, memo_ok;
  __shared__ int counts[kThreads / 32];      // block search: goes_right pivots of each warp
  __shared__ uint32_t spans[4 * kSeq];       // block search: each end's span after a round

  const int tid = threadIdx.x;
  const int64_t n_tiles = (q_rows + kTile - 1) / kTile;
  const int32_t* qsrc[2] = {q0, q1};
  auto right = [](int k) { return kMode == kRight || (kMode == kRange && k >= kPer); };
  auto in_tile = [&](int k, int n_t) { return tid + (k % kPer) * kThreads < n_t; };

  if (tid == 0) {
    for (int i = 0; i <= kQBufs; ++i) mbar_init(&bars[i]);
    memo_ok = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // one bulk copy per sequence of a tile; the int32 offset of its first row
  // in the buffer is the same for every tile (kTile * 12 is a multiple of 16)
  auto issue_tile = [&](int64_t tile, int buf) {
    const int64_t r0 = tile * kTile;
    const int64_t n = q_rows - r0 < kTile ? q_rows - r0 : kTile;
    Span sp[kSeq];
    uint32_t total = 0;
    for (int s = 0; s < kSeq; ++s) {
      sp[s] = row_span(qsrc[s], r0, n);
      total += sp[s].bytes;
    }
    mbar_expect_tx(&bars[buf], total);  // the barrier's one arrival, before any copy
    for (int s = 0; s < kSeq; ++s) bulk_load(qbuf + (buf * kSeq + s) * kQBytes, sp[s].src, sp[s].bytes, &bars[buf]);
  };
  for (int i = 0; i < kQBufs - 1; ++i)
    if (tid == 0 && blockIdx.x + static_cast<int64_t>(i) * gridDim.x < n_tiles)
      issue_tile(blockIdx.x + static_cast<int64_t>(i) * gridDim.x, i);
  int qoff[kSeq];
#pragma unroll
  for (int s = 0; s < kSeq; ++s) qoff[s] = static_cast<int>((reinterpret_cast<uintptr_t>(qsrc[s]) & 15) / 4);

  // block splitters: kSplitRows evenly spaced rows of [0, S), staged when
  // this block takes more than one tile (one round of loads, which saves
  // rounds in every later tile's searches); every row of a store of at most
  // kSplitRows rows, which is then searched here alone
  const bool whole = s_rows <= kSplitRows;
  const bool staged = whole || blockIdx.x + gridDim.x < n_tiles;
  const int m_blk = staged ? static_cast<int>(s_rows < kSplitRows ? s_rows : kSplitRows) : 0;
  const Splitters blk{bspl, m_blk, 0, s_rows};
  for (int j = tid; j < m_blk; j += kThreads) {
    const Row r = ldg_row(store, blk.pos(j));
    bspl[3 * j] = r.s;
    bspl[3 * j + 1] = r.p;
    bspl[3 * j + 2] = r.o;
  }
  __syncthreads();

  uint32_t phases = 0;  // bit i: the parity buffer i waits for
  uint32_t wphase = 0;
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = it % kQBufs;
    const int64_t r0 = tile * kTile;
    const int n_t = static_cast<int>(q_rows - r0 < kTile ? q_rows - r0 : kTile);
    if (tid == 0) bulk_wait_read();  // the last tile's answers left its buffer
    mbar_wait(&bars[b], (phases >> b) & 1);
    phases ^= 1u << b;
    // the buffer two tiles ahead was last read, and its answers stored,
    // before the previous tile's final barrier
    const int64_t ahead = tile + static_cast<int64_t>(kQBufs - 1) * gridDim.x;
    if (tid == 0 && ahead < n_tiles) issue_tile(ahead, (it + kQBufs - 1) % kQBufs);

    const int32_t* qt[kSeq];
#pragma unroll
    for (int s = 0; s < kSeq; ++s)
      qt[s] = reinterpret_cast<const int32_t*>(qbuf + (b * kSeq + s) * kQBytes) + qoff[s];

    // 1. this thread's queries, and the tile's sortedness
    Row q[kN];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = tid + (k % kPer) * kThreads;
      q[k] = Row{0, 0, 0};
      if (i < n_t) {
        q[k] = smem_row(qt[k / kPer], i);
        if (i > 0 && lex_less(q[k], smem_row(qt[k / kPer], i - 1))) ok = false;
      }
    }
    const bool sorted = __syncthreads_and(ok) != 0;
    bool equal = sorted;
    bool memo_hit = memo_ok != 0;
#pragma unroll
    for (int s = 0; s < kSeq; ++s) {
      const Row first = smem_row(qt[s], 0);
      equal = equal && row_eq(first, smem_row(qt[s], n_t - 1));
      memo_hit = memo_hit && row_eq(first, memo_q[s]);
    }
    memo_hit = memo_hit && equal;

    // 2. the window: the block searches each sequence's first and last
    //    query (end e = 2 s + last); a tile of equal queries reuses the
    //    answers of the block's last such tile when its rows are the same
    if (sorted && !memo_hit) {
      constexpr int kEnds = 2 * kSeq;
      const int e = tid / (kThreads / kEnds);
      const int s = e >> 1;
      const Row qe = smem_row(qt[s], (e & 1) ? n_t - 1 : 0);
      const bool r_side = kMode == kRight || (kMode == kRange && s == 1);
      const uint32_t pos = block_search<kEnds>(store, blk, r_side, qe, !equal, counts, spans);
      if (tid % (kThreads / kEnds) == 0) {
        ends[s][e & 1] = pos;
        if (equal && (e & 1) == 0) {
          memo_q[s] = qe;
          memo_pos[s] = pos;
          if (kFound) memo_found = pos < s_rows && row_eq(ldg_row(store, pos), qe);
        }
      }
    }
    __syncthreads();
    if (tid == 0 && equal && !memo_hit) memo_ok = 1;  // read again only after the next tile's barriers
    // no thread reads the tile's queries from shared memory past this point:
    // its buffer stages the answers
    int32_t* st0 = reinterpret_cast<int32_t*>(qbuf + b * kSeq * kQBytes);
    unsigned char* st1 = reinterpret_cast<unsigned char*>(st0 + kTile);

    uint32_t lo[kN], hi[kN];
    bool eq[kN], known[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) eq[k] = known[k] = false;
    int path = 2;
    if (equal) {
      path = 0;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        lo[k] = hi[k] = memo_pos[k / kPer];
        eq[k] = memo_found != 0;
        known[k] = true;
      }
    } else if (sorted) {
      uint32_t w0 = ends[0][0], w1 = ends[0][1];
#pragma unroll
      for (int s = 1; s < kSeq; ++s) {
        w0 = ends[s][0] < w0 ? ends[s][0] : w0;
        w1 = ends[s][1] > w1 ? ends[s][1] : w1;
      }
      // rows [w0, w1) decide every answer; row w1 is read for found
      const uint32_t w_end = w1 + 1 < s_rows ? w1 + 1 : s_rows;
      const uint32_t n_win = w_end > w0 ? w_end - w0 : 0;
      if (n_win <= kWindowRows) {
        // 3a. the window in shared memory (the block splitters hold a whole small store)
        path = 0;
        if (!whole && n_win > 0) {
          if (tid == 0) {
            const Span sp = row_span(store, w0, n_win);
            woff_s = sp.off;
            mbar_expect_tx(&bars[kQBufs], sp.bytes);
            bulk_load(win, sp.src, sp.bytes, &bars[kQBufs]);
          }
          mbar_wait(&bars[kQBufs], wphase);
          wphase ^= 1;
        }
        __syncthreads();
        const int32_t* wrows = whole ? bspl + 3 * w0 : win + woff_s;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          lo[k] = 0;
          hi[k] = in_tile(k, n_t) ? w1 - w0 : 0;
        }
        lockstep_search<kN, false>(lo, hi, q, eq, known, right, [&](uint32_t i) { return smem_row(wrows, i); });
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          if (kFound) {
            eq[k] = w0 + lo[k] < s_rows && row_eq(smem_row(wrows, lo[k]), q[k]);
            known[k] = true;
          }
          lo[k] += w0;
        }
      } else {
        // 3b. oversized: kWindowRows splitters of [w0, w1]
        path = 1;
        const Splitters wsp{win, kWindowRows, w0, w1 - w0};
        for (int j = tid; j < kWindowRows; j += kThreads) {
          const Row r = ldg_row(store, wsp.pos(j));
          win[3 * j] = r.s;
          win[3 * j + 1] = r.p;
          win[3 * j + 2] = r.o;
        }
        fence_async_smem();  // a later tile's bulk copy writes these bytes again
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          lo[k] = hi[k] = 0;
          if (in_tile(k, n_t)) {
            const int c = wsp.bounds(right(k), q[k], lo[k], hi[k]);
            if (kFound && c < wsp.m) {
              eq[k] = row_eq(smem_row(wsp.rows, c), q[k]);
              known[k] = true;
            }
          }
        }
      }
    }
    if (path == 2) {
      // 3c. unsorted: the block splitters of [0, S)
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        lo[k] = hi[k] = 0;
        if (in_tile(k, n_t)) {
          const int c = blk.bounds(right(k), q[k], lo[k], hi[k]);
          if (kFound) {
            eq[k] = c < blk.m && row_eq(smem_row(blk.rows, c), q[k]);
            known[k] = true;  // hi is a splitter's row, or S
          }
        }
      }
    }
    if (path != 0) {
      lockstep_search<kN, kFound>(lo, hi, q, eq, known, right,
                                           [&](uint32_t i) { return ldg_row(store, i); });
    }

    // 4. stage the answers
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int qi = tid + (k % kPer) * kThreads;
      if (qi >= n_t) continue;
      if (k < kPer) {
        st0[qi] = static_cast<int32_t>(lo[k]);
      } else {
        reinterpret_cast<int32_t*>(st1)[qi] = static_cast<int32_t>(lo[k]);
      }
      if (kFound) {
        // the row at the answer was compared, or is w1 of an oversized
        // window (read here)
        const bool hit = lo[k] < s_rows && (known[k] ? eq[k] : row_eq(ldg_row(store, lo[k]), q[k]));
        st1[qi] = hit ? 1 : 0;
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      store_out(out0 + r0, st0, 4 * n_t);
      if (kMode == kLeft) store_out(static_cast<uint8_t*>(out1) + r0, st1, n_t);
      if (kMode == kRange) store_out(static_cast<int32_t*>(out1) + r0, st1, 4 * n_t);
      bulk_commit();
      if (tile_counts != nullptr) atomicAdd(tile_counts + path, 1);
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int kMode>
cudaError_t launch(const int32_t* store, int64_t s, const int32_t* q0, const int32_t* q1, int64_t q,
                   int32_t* out0, void* out1, int32_t* tile_counts, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<kMode>();
  static int device = -1;
  static int grid_max = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != device) {
    err = cudaFuncSetAttribute(merge_probe_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_probe_kernel<kMode>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_max = sms * per_sm;
    device = dev;
  }
  const int64_t n_tiles = (q + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(n_tiles < grid_max ? n_tiles : grid_max);
  merge_probe_kernel<kMode><<<grid, kThreads, bytes, stream>>>(store, static_cast<uint32_t>(s), q0, q1, q, out0,
                                                                 out1, tile_counts);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 = left (out0 idx, out1 found uint8[q]), 1 = right (out0 idx; out1
// unused), 2 = range (q0 searched left into out0, q1 right into out1 int32[q]).
// Outputs must be 16-byte aligned; tile_counts (int32[3], optional) gains the
// tiles of each path: window in shared memory, window too large, unsorted.
extern "C" int merge_probe_launch(const int32_t* store, int64_t s, const int32_t* q0, const int32_t* q1,
                                  int64_t q, int mode, int32_t* out0, void* out1, int32_t* tile_counts,
                                  cudaStream_t stream) {
  if (q <= 0) return 0;
  if (s < 0 || s >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (out0 == nullptr || q0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == 0 || mode == 2) && out1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2 && q1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  switch (mode) {
    case 0: err = launch<kLeft>(store, s, q0, q1, q, out0, out1, tile_counts, stream); break;
    case 1: err = launch<kRight>(store, s, q0, q1, q, out0, out1, tile_counts, stream); break;
    case 2: err = launch<kRange>(store, s, q0, q1, q, out0, out1, tile_counts, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
