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
// Bound on an H100: bytes. Each row is read once with its seg word (16 B)
// and each plane's words written once (4 n_seg W B a row); the work, three
// table lookups a valid row and W ANDs a plane, is done once per row, not
// once per plane, and is far below the card's int32 rate. The design is K4's
// (bank_slot_masks.cuh): per-position slot masks built once a block in
// shared memory, and a persistent grid streaming 4 rows a thread, their seg
// words as one 16-byte load, each plane's 4 rows of words as one 16-byte
// store. The TPU kernel's tiles of 32 x 128 rows and its 4096-row padding
// are not carried over: any n is taken.
#include "bank_slot_masks.cuh"

namespace {
constexpr int kMaxSegments = 32;
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
  return launch_bank_words<true>(spo, seg, n, bank, n_pat, n_words, n_seg, out, stream);
}
