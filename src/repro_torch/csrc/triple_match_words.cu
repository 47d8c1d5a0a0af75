// Multi-word bank bitset: every bank word of every triple row in one pass.
//
// Replaces the Pallas kernel
// repro/kernels/triple_match.py::triple_match_words_pallas (K4). Word w of row
// i carries bit j set iff row i matches bank[32 w + j]; a pattern slot of -1 is
// a wildcard, PAD rows (s == INT32_MAX) give 0, and all-PAD bank rows (padding
// and tombstoned lanes) never match a valid row. The words are the bits of
// uint32, stored as int32, row-major int32[N, W] (the layout the ops layer
// hands out, so no transpose follows).
//
// Bound on an H100: bytes. Each row is read once (12 B) and its W words
// written once (4 W B); the work, three table lookups a valid row and W ANDs,
// is far below the card's int32 rate. The design (bank_slot_masks.cuh, shared
// with K6): per-position slot masks built once a block in shared memory in
// place of a loop over the bank rows, and a persistent grid streaming 4 rows a
// thread by 16-byte loads and stores. The TPU tiling ((N/128, 128) blocks of
// 32 rows, 4096-row padding) is not carried over.
#include "bank_slot_masks.cuh"

// n_words must be max(1, ceil(n_pat / 32)); out is int32[n, n_words].
extern "C" int triple_match_words_launch(const int32_t* spo, int64_t n, const int32_t* bank,
                                         int n_pat, int n_words, int32_t* out,
                                         cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pat < 0 || n_words != (n_pat > 0 ? (n_pat + 31) / 32 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bank_words<false>(spo, nullptr, n, bank, n_pat, n_words, 1, out, stream);
}
