#!/usr/bin/env python3
"""Time the port's K1, K4, K5, K6 and K7 kernels against another tree's, on one CUDA card.

    python3 experiments/torch_kernel_ab.py --old DIR

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive``). The script builds
``csrc/triple_match.cu`` (K1), ``csrc/triple_match_words.cu`` (K4),
``csrc/triple_match_lanes.cu`` (K5), ``csrc/triple_match_words_segmented.cu``
(K6) and ``csrc/lane_refine.cu`` (K7) of this tree through ``repro_torch.kernels.build`` and those of ``DIR``
with the same ``nvcc`` flags, checks both against the plain versions, and
times them in turns (old, new, new, old) at synthetic shapes of the main
path:

- K1: N = 1,179,648 rows (a quarter of them PAD), P = 6 patterns;
- K4: a single-frontier fire's deleted side, N = 131,072 rows of which
  100,974 are valid (a PAD tail), a bank of 32 rows with 9 live (constants
  at p and o, the rest all-PAD padding), W = 1;
- K5: the category cohort's added side, R = 32 members of which 20 are
  active, N = 196,608 rows a member, each active member a PAD-tailed store
  holding about half of them (~51% of the active rows valid), nt = 3 lanes
  into a bank of 96 rows; and the broker's widest lanes pass by bytes, R =
  16 with 10 active, N = 786,432;
- K6: the flush's union, N = 524,288 rows of which 403,925 are valid, the
  same bank, n_seg = 2 with membership bits 0-2 drawn per row;
- K7: F = 2 planes over N = 524,288 shared rows (a quarter PAD), W = 1 with 9
  real lanes, Vp = 64 with 41 live slots under 2 parent lanes, o-constants
  that 30% of the rows hit.

Each time is the median of 50 launches with the L2 flushed before each, two
ways: by zeroing 256 MiB (the lines left dirty, as ``chip_smoke.py``
flushes) and by reading them (left clean). Beside the kernels: a
one-element fill (the launch floor) and a device copy that moves the same
bytes as each kernel (``copy_``, half read and half written). Then K7 at N =
256 rows, one block, with Vp = 64 and Vp = 0 (the table build's cost), and
with Vp = 64 right after a one-row launch of the same kernel (the code,
parents and residual back in the caches, the rows still cold).
Prints the card, one line a measurement and a JSON line of all of them.
Needs a card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PAD = int(np.iinfo(np.int32).max)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="another checkout of the repository")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab.py needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import (build, lane_refine, ref, triple_match, triple_match_lanes, triple_match_words,
                                     triple_match_words_segmented)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    wrappers = {"triple_match": triple_match, "triple_match_words": triple_match_words,
                "triple_match_lanes": triple_match_lanes,
                "triple_match_words_segmented": triple_match_words_segmented, "lane_refine": lane_refine}
    build.build(list(wrappers))
    out_dir = REPO / "build" / "kernels_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    old = {}
    for name in wrappers:
        so = out_dir / f"old_{name}.so"
        src = args.old / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return 1
        fn = getattr(ctypes.CDLL(str(so)), f"{name}_launch")
        fn.argtypes = wrappers[name]._entry().argtypes
        fn.restype = ctypes.c_int
        old[name] = fn

    dev = torch.device("cuda", 0)
    scratch = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    flushes = {"dirty": scratch.zero_, "clean": lambda: scratch.view(torch.int64).max()}

    def timed(fn, flush) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.iters):
            flush()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    rng = np.random.default_rng(0)
    # K1
    n1 = 1_179_648
    spo1 = rng.integers(0, 50, size=(n1, 3)).astype(np.int32)
    spo1[3 * n1 // 4:] = PAD
    s1 = torch.as_tensor(spo1, device=dev)
    p1 = torch.as_tensor(rng.integers(-1, 50, size=(6, 3)).astype(np.int32), device=dev)
    want1 = ref.pattern_bitmask_ref(s1, p1)
    o1 = torch.empty_like(want1)

    def k1_old():
        if old["triple_match"](s1.data_ptr(), n1, p1.data_ptr(), 6, o1.data_ptr(), stream()) != 0:
            raise RuntimeError("old triple_match launch")

    # K7
    n7, f7 = 524_288, 2
    spo7 = rng.integers(0, 1000, size=(n7, 3)).astype(np.int32)
    spo7[3 * n7 // 4:] = PAD
    words = (rng.integers(0, 1 << 9, size=(f7, n7, 1)) & rng.integers(0, 1 << 9, size=(f7, n7, 1))).astype(np.int32)
    words[:, 3 * n7 // 4:] = 0
    parents = np.full(64, -1, np.int32)
    residual = np.full((64, 3), PAD, np.int32)
    live = rng.choice(64, 41, replace=False)
    parents[live] = rng.choice([2, 5], 41)
    residual[live] = -1
    residual[live, 2] = rng.integers(0, 1000, 41)
    hit = rng.random(n7) < 0.3
    spo7[hit, 2] = rng.choice(residual[live, 2], int(hit.sum()))
    a7 = [torch.as_tensor(x, device=dev) for x in (spo7, words, parents, residual)]
    want7 = ref.lane_refine_ref(*a7)
    o7 = torch.empty_like(want7)

    def k7_old():
        s, w, p, r = a7
        if old["lane_refine"](s.data_ptr(), 0, w.data_ptr(), f7, n7, 1, p.data_ptr(), r.data_ptr(), 64, 2,
                              o7.data_ptr(), stream()) != 0:
            raise RuntimeError("old lane_refine launch")

    # K4 and K6: 9 live bank rows of a 32-row bank, the rows' valid prefix
    # hitting their constants
    bank = np.full((32, 3), PAD, np.int32)
    bank[:9] = [[-1, 1, 100], [-1, 1, 101], [-1, 2, -1], [-1, 3, -1], [-1, 4, 102], [-1, 5, -1], [-1, 6, -1],
                [-1, 1, -1], [7, 2, -1]]
    t_bank = torch.as_tensor(bank, device=dev)

    def bank_rows(n, valid):
        spo = np.stack([rng.integers(0, 50_000, n), rng.integers(0, 10, n), rng.integers(95, 110, n)], 1)
        spo = spo.astype(np.int32)
        spo[valid:] = PAD
        return torch.as_tensor(spo, device=dev)

    n4, n6 = 131_072, 524_288
    s4, s6 = bank_rows(n4, 100_974), bank_rows(n6, 403_925)
    g6 = torch.as_tensor(rng.integers(0, 8, n6).astype(np.int32), device=dev)
    want4 = ref.pattern_bitmask_words_ref(s4, t_bank)
    want6 = ref.pattern_bitmask_words_segmented_ref(s6, t_bank, g6, 2)
    o4, o6 = torch.empty_like(want4), torch.empty_like(want6)

    def k4_old():
        if old["triple_match_words"](s4.data_ptr(), n4, t_bank.data_ptr(), 32, 1, o4.data_ptr(), stream()) != 0:
            raise RuntimeError("old triple_match_words launch")

    def k6_old():
        if old["triple_match_words_segmented"](s6.data_ptr(), g6.data_ptr(), n6, t_bank.data_ptr(), 32, 1, 2,
                                               o6.data_ptr(), stream()) != 0:
            raise RuntimeError("old triple_match_words_segmented launch")

    def k4_new():
        return triple_match_words.triple_match_words_cuda(s4, t_bank)

    def k6_new():
        return triple_match_words_segmented.triple_match_words_segmented_cuda(s6, t_bank, g6, 2)

    # K5: each active member a PAD-tailed store of about half its N rows,
    # a third of them carrying its lanes' constants; inactive members all PAD
    bank5 = np.full((96, 3), PAD, np.int32)
    bank5[:, 0] = -1
    bank5[:, 1] = rng.integers(0, 10, 96)
    bank5[::2, 2] = -1
    bank5[1::2, 2] = rng.integers(95, 110, 48)
    t_bank5 = torch.as_tensor(bank5, device=dev)

    def lanes_cohort(r, n, n_active):
        lanes = rng.integers(0, 96, size=(r, 3)).astype(np.int32)
        active = np.zeros(r, np.int32)
        active[:n_active] = 1
        spo = np.full((r, n, 3), PAD, np.int32)
        for k in range(n_active):
            valid = int(n * rng.uniform(0.45, 0.57))
            rows = np.stack([np.sort(rng.integers(0, 1 << 24, valid)), rng.integers(0, 10, valid),
                             rng.integers(95, 110, valid)], 1)
            hit = rng.random(valid) < 1 / 3
            pats = bank5[lanes[k, rng.integers(0, 3, int(hit.sum()))]]
            rows[hit] = np.where(pats == -1, rows[hit], pats)
            spo[k, :valid] = rows
        return [torch.as_tensor(x, device=dev) for x in (spo, lanes, active)]

    lanes_shapes = {"K5": (32, 196_608, 20), "K5 wide": (16, 786_432, 10)}
    cohorts = {label: lanes_cohort(*shape) for label, shape in lanes_shapes.items()}
    want5 = {label: ref.pattern_lane_bits_ref(s, t_bank5, ln, a) for label, (s, ln, a) in cohorts.items()}
    o5 = {label: torch.empty_like(w) for label, w in want5.items()}

    def k5_old(label):
        s, ln, a = cohorts[label]
        if old["triple_match_lanes"](s.data_ptr(), s.shape[0], s.shape[1], t_bank5.data_ptr(), 96, ln.data_ptr(),
                                     3, a.data_ptr(), o5[label].data_ptr(), stream()) != 0:
            raise RuntimeError("old triple_match_lanes launch")

    def k5_new(label):
        s, ln, a = cohorts[label]
        return triple_match_lanes.triple_match_lanes_cuda(s, t_bank5, ln, a)

    for label in cohorts:
        k5_old(label)
    k1_old()
    k4_old()
    k6_old()
    k7_old()
    torch.cuda.synchronize()
    for label, got, want in [("K1 old", o1, want1), ("K1 new", triple_match.triple_match_cuda(s1, p1), want1),
                             ("K4 old", o4, want4), ("K4 new", k4_new(), want4),
                             ("K5 old", o5["K5"], want5["K5"]), ("K5 new", k5_new("K5"), want5["K5"]),
                             ("K5 wide old", o5["K5 wide"], want5["K5 wide"]),
                             ("K5 wide new", k5_new("K5 wide"), want5["K5 wide"]),
                             ("K6 old", o6, want6), ("K6 new", k6_new(), want6),
                             ("K7 old", o7, want7), ("K7 new", lane_refine.lane_refine_cuda(*a7), want7)]:
        if not torch.equal(got, want):
            print(f"{label} != plain", file=sys.stderr)
            return 1

    def copy_of(n_bytes: int):
        half = torch.empty(n_bytes // 8, dtype=torch.int32, device=dev)
        other = torch.empty_like(half)
        return lambda: other.copy_(half)

    one = torch.empty(1, dtype=torch.int32, device=dev)
    k1_bytes = n1 * 16 + 6 * 12
    k4_bytes = n4 * 16 + 32 * 12
    k6_bytes = n6 * 16 + 2 * n6 * 4 + 32 * 12
    k7_bytes = n7 * 12 + f7 * n7 * (4 + 8) + 64 * 16
    # K5: the active members' rows read once, every member's words written once
    k5_bytes = {label: n_active * n * 12 + r * n * 4 for label, (r, n, n_active) in lanes_shapes.items()}
    cases = {
        "floor": lambda: one.fill_(0),
        "copy of K1's bytes": copy_of(k1_bytes),
        "K1 old": k1_old, "K1 new": lambda: triple_match.triple_match_cuda(s1, p1),
        "copy of K4's bytes": copy_of(k4_bytes),
        "K4 old": k4_old, "K4 new": k4_new,
        "copy of K5's bytes": copy_of(k5_bytes["K5"]),
        "K5 old": lambda: k5_old("K5"), "K5 new": lambda: k5_new("K5"),
        "copy of K5 wide's bytes": copy_of(k5_bytes["K5 wide"]),
        "K5 wide old": lambda: k5_old("K5 wide"), "K5 wide new": lambda: k5_new("K5 wide"),
        "copy of K6's bytes": copy_of(k6_bytes),
        "K6 old": k6_old, "K6 new": k6_new,
        "copy of K7's bytes": copy_of(k7_bytes),
        "K7 old": k7_old, "K7 new": lambda: lane_refine.lane_refine_cuda(*a7),
    }
    result = {"card": card}
    for mode, flush in flushes.items():
        row = {}
        for label in ("floor", "copy of K1's bytes", "copy of K4's bytes", "copy of K5's bytes",
                      "copy of K5 wide's bytes", "copy of K6's bytes", "copy of K7's bytes"):
            row[label] = timed(cases[label], flush)
        for pair in (("K1 old", "K1 new"), ("K4 old", "K4 new"), ("K5 old", "K5 new"), ("K5 wide old", "K5 wide new"),
                     ("K6 old", "K6 new"), ("K7 old", "K7 new")):
            first = {label: timed(cases[label], flush) for label in pair}
            second = {label: timed(cases[label], flush) for label in reversed(pair)}
            for label in pair:
                row[label] = [first[label], second[label]]
        result[mode] = row
        print(f"L2 {mode}: " + ", ".join(f"{k} {v}" for k, v in row.items()))
    small = [a7[0][:256].contiguous(), a7[1][:, :256].contiguous(), a7[2], a7[3]]
    empty = small[:2] + [a7[2][:0], a7[3][:0]]
    result["K7 N=256 Vp=64"] = timed(lambda: lane_refine.lane_refine_cuda(*small), flushes["dirty"])
    result["K7 N=256 Vp=0"] = timed(lambda: lane_refine.lane_refine_cuda(*empty), flushes["dirty"])
    tiny = [a7[0][:1].contiguous(), a7[1][:, :1].contiguous(), a7[2], a7[3]]

    def warmed():  # the flush, then a one-row launch that brings the code, parents and residual back
        flushes["dirty"]()
        lane_refine.lane_refine_cuda(*tiny)

    result["K7 N=256 Vp=64 warmed"] = timed(lambda: lane_refine.lane_refine_cuda(*small), warmed)
    print(f"K7 at N=256 (one block), L2 dirty: Vp=64 {result['K7 N=256 Vp=64']} ms, "
          f"Vp=0 {result['K7 N=256 Vp=0']} ms, Vp=64 after a one-row launch {result['K7 N=256 Vp=64 warmed']} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
