#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py [--seed 0] [--changesets 3]

Phases, each fatal on failure:

1. build: the card's name and power limit; the six CUDA sources built with
   ``nvcc`` for ``sm_90a`` from ``src/repro_torch/csrc``, in parallel.
2. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, at edge cases (PAD rows, wildcard-only and 32-pattern banks,
   duplicate, absent and skewed queries, both sides; each tile path of the
   probe (sorted tiles, all-equal tiles, windows of W_max - 1, W_max and
   W_max + 1 rows, unsorted and mixed tiles, INT32_MIN columns and mixed
   prefix depths, a ragged last tile, stores of 0 and 1 rows) on the left,
   the right and in range mode, with its tile counts; bank widths of 1, 2
   and 5 words, all-tombstone words, inactive members; 1, 2 and 32
   segments with bits above them; 1 to 64 virtual slots with dead ones; K1's
   row stream at N % 4 of 1-3, bases offset by 1-3 rows, P of 0, 1 and 32,
   all-PAD rows; K7's slot masks with two and three constants a slot, 600
   distinct constants at one position, Vp of 0 to 600 over several chunks of
   output words, W = 10, parents at and beyond 32 W, F = 1, 2 and 32 over
   shared and per-plane rows, N below one block; K4's and K6's slot masks
   with many slots sharing one constant, 320 distinct constants at one
   position, wildcard-only, all-PAD and partly PAD slots, W = 1, 2, 5 and
   10, bases offset by 1-3 rows, N % 4 of 1-3, N below one group, all-PAD
   rows, 1, 2, 3 and 32 segments, rows of no segment; K5's row stream at
   N % 4 of 1-3 (each member its own alignment), N < 4, bases offset by a
   row and sliced along R, nt of 0 and 32, lanes outside the bank,
   lex-sorted PAD-tailed and all-PAD members, every member inactive, more
   members than the grid holds blocks, several staging chunks); K4, K5 and
   K6 at the sharded cohort step's block-sliced views (4 shards of 2^17
   rows, 3 shards of 2^17 + 1 whose last block overlaps the one before),
   each block and the stitched blocks against the plain versions.
3. small: the paper's running example, and a small id-space stream with the
   Football and Location interests, through ``IrapEngine`` on the card; every
   named set equals the pure-Python oracle's; then both through the default
   ``Broker`` (subsumption lattice, delta frontier chains) against the
   oracle.
4. full scale: Football and Location over replicas of DBpedia-like size
   (the Location replica holds ~0.7M places' rows, several million triples)
   and changesets of ~10^5 rows a side. Run once through the kernels, with
   the launch counters set to 0 just before and read just after, and once
   with the plain versions on the same card; every output store (τ', ρ', r,
   r_i, r', a, a_i) must be bit-identical. Then ``make_distributed_evaluator``
   over 4 logical shards of the card, on the Football interest's
   hash-partitioned τ0 and both sides of a changeset, must equal the
   single-device evaluator (its K1 and K2 launches counted).
5. broker: 48 subscribers (Football, Location and 40 category interests,
   four policies; the categories' patterns ride virtual lanes under
   Location's) through the default ``Broker`` over the same kind of dump: 4
   changesets and a flush that fires two frontiers through the delta chain.
   Through the kernels (counted), through the plain versions (bit-identical),
   against the port's ``IrapEngine``, and through the kernels again with the
   lattice and the chain off (bit-identical, fire by fire).
6. fan-out: 256 eager subscribers drawn from 10 interests, each written four
   ways, evaluated as 10 lane groups over 3 changesets; every member equals
   its group and ``IrapEngine`` on its own expression.
7. timing: each kernel at the full-scale shapes, against its plain version
   and the card's bound (bytes at 3.35 TB/s, int32 operations at the SMs'
   int32 lanes and clock), the probe's tiles per path at each shape, the
   probe once more with the prefix queries shuffled and in range mode
   against two single-side launches; the launch floor (a one-element fill
   timed the same way; K4's, K6's and K7's restated bounds beside their old
   per-slot ones; K5 at the broker's widest lanes pass too); one JSON line
   ``{"kernels": [...]}``. Then one
   more changeset per interest, and one more broker fire, under
   ``torch.profiler``: the device's busy share and where its time goes.
8. durable: the broker phase's 48 subscribers over the same dump, default
   ``Broker``, with a ``ChangesetJournal`` (fsync on every append) and a
   ``DeliveryChannel`` on a fake clock whose transport fails one delivery
   (it backs off and catches up at the next ingest); a snapshot and a
   journal compaction after the second changeset; the closing flush. Then
   crashes at three record boundaries (before the snapshot, after it, and
   at the last record), each recovered by ``Broker.recover`` on the card
   and held bit for bit against the state captured at that boundary; the
   kernel launches of the three recoveries (each of K2/K3, K4, K5, K6 and
   K7 above 0); the last recovery and the uninterrupted broker take one
   more changeset and must stay equal. Journal bytes and append time per
   ingest record, the snapshot's seconds and bytes, each recovery's
   seconds and the phase's peak device memory, stamped with the card.
9. sharded: the broker phase's 48 subscribers over the same kind of dump,
   at its capacities but without candidate dedup (the sharded step
   refuses it), through three
   default brokers in lockstep: unsharded, sharded over
   ``DeviceMesh.on_card(4)`` (4 logical shards of the card, one thread a
   shard) and placed by load over the same mesh; every fire of the sharded
   and the placed broker must equal the unsharded one bit for bit, with
   launches of K2, K4, K5 and K6 in the sharded run and of K7 in the
   placed run (counted per call, summed). Each call's time, the sharded
   run's probe exchange bytes and the phase's peak device memory, stamped
   with the card.

10. models: the model plane's serving path at full published widths,
   float32 parameters and bfloat16 compute unless stated, each model freed
   before the next: phase 4's Football replica τ verbalized
   (``Verbalizer``), batched (``ReplicaTokenPipeline``, 4 x 32) and served
   by internlm2-1.8b through ``launch/serve``'s prefill and 16 greedy
   decode steps (one decode step profiled); granite-moe-3b-a800m's expert
   banks perturbed on a seeded quarter of their (layer, expert) rows and
   published as one ``diff_bank`` changeset a bank to a mirror replica
   (logits bit-identical to the source's) and a replica of the even
   experts (those rows the source's, the others the old weights); gemma3-4b
   in float32 with TF32 off, a decode step at position 1,100 over the
   wrapped ring (window 1,024) against a 1,101-token prefill; whisper-medium
   (enc_seq 1,500) and llama-3.2-vision-90b cut to one group (5 of 100
   layers, gates nonzero), prefill and 8 decode steps; internlm2-1.8b cut to
   2 layers, float32, one prefill and one decode step on the card and on
   the CPU with the same weights. Then the state-space families:
   falcon-mamba-7b (64 Mamba-1 layers) and zamba2-7b (81 Mamba-2 layers,
   one shared attention block after each group of 6) at full width, each
   served 4 x 32 through ``launch/serve`` with 16 decode steps, then in
   float32 with TF32 off a 1,024-token prefill (2 Mamba-1 chunks of 512,
   or 4 SSD chunks of 256) against a 1,023-token prefill (one chunk) and a
   decode step; falcon-mamba cut to 2 layers and zamba2 to 7 (one group,
   its shared block, one tail layer) on the card and on the CPU. Prefill
   and decode milliseconds, peak device memory, bytes offered and
   received, stamped with the card.
11. train: internlm2-1.8b at full width (float32 parameters, bfloat16
   compute) trained through ``launch/train.main`` for 50 steps on
   ``build_data``'s replica-fed 4 x 64 batches, with the launch counters
   set to 0 just before and read just after: the subscription's refresh at
   the 50th batch runs K1 and K2 on the card. AdamW with launch/train's
   cosine warm-up, weight decay and clipping; one snapshot (params, m, v in
   the reference's layout) at the last step, timed, in a temporary
   directory under ``build/`` after a check of the free disk, removed
   after. The median step time after warm-up (the loss read back inside
   the timed step), tokens/s, first and last loss, peak device memory.
   Then ``ErrorFeedbackInt8(AdamW)`` for 3 steps at full width with its
   peak memory; a failure injected at step 4 of internlm2 cut to 2 layers
   and a new ``Trainer`` that resumes at the step-3 snapshot and continues
   with step 4; and at 2 layers in float32 with TF32 off, the gradients of
   one ``train_loss`` and the parameters after one AdamW step on the card
   and on the CPU from the same weights (tolerances at ``GRAD_TOL`` and
   ``STEP_REL``), and ``quantize_int8`` of every card gradient on both,
   bit for bit. No step falls back to the CPU.

The last line of standard output is ``{"ok": true, "device": {...}}``. The
script exits non-zero, printing no result, when no CUDA card is available
or when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The kernels' operations are int32 (compares, ands, shifts): their peak is
# the SMs' int32 lanes at the SM clock, 64 lanes an SM on Hopper (4
# partitions x 16 INT32 units, NVIDIA H100 architecture white paper). The
# rate is set in phase_build from the SM count and `nvidia-smi
# --query-gpu=clocks.max.sm`: 132 x 64 x 1.98 GHz = 1.67e13 on an H100 SXM.
INT32_LANES_PER_SM = 64
INT_OPS_PER_S = 132 * INT32_LANES_PER_SM * 1.98e9

A = "rdf:type"
FOOTBALL = (
    [
        ("?footballer", A, "dbo:SoccerPlayer"),
        ("?footballer", "foaf:name", "?name"),
        ("?footballer", "dbo:team", "?team"),
        ("?team", "rdfs:label", "?teamName"),
    ],
    [],
)
LOCATION = (
    [
        ("?location", A, "?type"),
        ("?location", "wgs:long", "?long"),
        ("?location", "wgs:lat", "?lat"),
        ("?location", "rdfs:label", "?label"),
        ("?location", "dbo:abstract", "?abstract"),
    ],
    [("?location", "dcterms:subject", "?subject")],
)
N_CATEGORIES = 40
CATEGORIES = [f"dbc:Category{k}" for k in range(N_CATEGORIES)]


def category_interest(k: int):
    """Places of category k: type, subject k and label."""
    return ([("?place", A, "dbo:Place"), ("?place", "dcterms:subject", CATEGORIES[k]),
             ("?place", "rdfs:label", "?label")], [])


OUT_FIELDS = ("r", "r_i", "r_prime", "a", "a_i")
STORE_FIELDS = (*OUT_FIELDS, "tau", "rho")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# id-space DBpedia-like data (the templates of data/changeset_gen.py)
# ---------------------------------------------------------------------------

VOCAB = [
    A, "dbp:goals", "foaf:name", "dbo:team", "rdfs:label", "wgs:lat", "wgs:long",
    "dbo:abstract", "dcterms:subject", "foaf:homepage", "dbo:SoccerPlayer",
    "dbo:Place", "foaf:Person", "dbo:Work", "dbp:prop0", "dbp:prop1", "dbp:prop2",
    "dbp:prop3",
]


@dataclasses.dataclass(frozen=True)
class Scale:
    n_athletes: int
    n_places: int
    n_other: int
    n_teams: int
    adds: int
    removes: int


# Location: ~0.7M DBpedia places with their type/label/lat/long/abstract/
# subject rows; athletes, clubs and other entities in the ratios of the
# reference's benchmark generator; changesets of ~10^5 rows a side.
FULL = Scale(n_athletes=100_000, n_places=700_000, n_other=3_500_000, n_teams=25_000,
             adds=100_000, removes=100_000)
SMALL = Scale(n_athletes=30, n_places=60, n_other=200, n_teams=8, adds=200, removes=100)


def make_dictionary_class():
    from repro_torch.core import Dictionary

    class IdSpaceDictionary(Dictionary):
        """The vocabulary by name; entity and literal ids as reserved ranges.

        Strings for millions of entities would only be looked up by the
        engine to size its signature tables, so the generator works in id
        space and the dictionary counts reserved ids.
        """

        def __init__(self):
            super().__init__()
            for term in VOCAB:
                super().encode_term(term)
            self.n_ids = len(self._id_to_term)

        def reserve(self, n: int, names=()) -> int:
            """Reserve ``n`` ids; the first ``len(names)`` get those names."""
            start = self.n_ids
            self.n_ids += int(n)
            for k, name in enumerate(names):
                self._term_to_id[name] = start + k
            return start

        def __len__(self) -> int:
            return self.n_ids

        def encode_term(self, term: str) -> int:
            tid = self.lookup(term)
            if tid is None:
                raise KeyError(f"{term} is not in the id-space vocabulary")
            return tid

        @property
        def id_capacity(self) -> int:
            n = max(self.n_ids, 2)
            return 1 << (n - 1).bit_length()

    return IdSpaceDictionary


def rows_of(*cols) -> np.ndarray:
    return np.stack([np.broadcast_to(np.asarray(c, np.int64), np.shape(cols[0])) for c in cols],
                    axis=1).astype(np.int32)


ROW = np.dtype([("s", "<i4"), ("p", "<i4"), ("o", "<i4")])


def as_records(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows, dtype=np.int32).view(ROW).ravel()


def unique_rows(rows: np.ndarray) -> np.ndarray:
    return np.unique(as_records(rows)).view(np.int32).reshape(-1, 3)


class IdSpaceStream:
    """A DBpedia-Live-like dump and changeset stream built with numpy in id space.

    Entity templates follow ``repro_torch/data/changeset_gen.py``: athletes
    (type, name, team + the team's label, goals, sometimes a homepage),
    places (type, label, lat, long, mostly an abstract, half a subject),
    other entities (Person or Work, name, 1-4 numeric properties). A
    changeset removes random live rows, adds new athletes and places, updates
    athletes' goals (remove + add) and fills up with other entities.
    """

    def __init__(self, dictionary, scale: Scale, seed: int, n_changesets: int):
        self.d, self.scale = dictionary, scale
        self.rng = np.random.default_rng(seed)
        v = {t: dictionary.lookup(t) for t in VOCAB}
        self.v = v
        self.num = dictionary.reserve(1000)  # the literals "0" .. "999"
        self.cat = dictionary.reserve(N_CATEGORIES, names=CATEGORIES)
        # "%.4f" values of [-90, 90) and [-180, 180), fewer for a small dump
        self.n_lat = min(1_800_000, 10 * scale.n_places)
        self.n_long = min(3_600_000, 20 * scale.n_places)
        self.lat = dictionary.reserve(self.n_lat)
        self.long = dictionary.reserve(self.n_long)
        self.team_base = dictionary.reserve(2 * scale.n_teams)  # entity, label

        teams = self.team_base + 2 * np.arange(scale.n_teams)
        team_rows = rows_of(teams, v["rdfs:label"], teams + 1)
        ath = self._athletes(scale.n_athletes, np.ones(scale.n_athletes, bool))
        self.athletes = ath["ids"]
        places = self._places(scale.n_places, np.ones(scale.n_places, bool))
        others = self._others(scale.n_other)
        self.football_init = np.concatenate([ath["rows"], team_rows])
        self.location_init = places
        dump = np.concatenate([ath["rows"], team_rows, places, others])
        cap = dump.shape[0] + n_changesets * (scale.adds + 1000) * 2
        self.pool = np.empty((cap, 3), np.int32)
        self.pool[: dump.shape[0]] = dump
        self.alive = np.zeros(cap, bool)
        self.alive[: dump.shape[0]] = True
        self.size = dump.shape[0]
        # every dump athlete has a goals row; track where it lives in the pool
        self.goals_at = np.flatnonzero(ath["rows"][:, 1] == v["dbp:goals"])
        check(self.goals_at.shape[0] == scale.n_athletes, "dump athletes carry goals")

    def _ids(self, n: int, width: int) -> np.ndarray:
        return self.d.reserve(width * n) + width * np.arange(n)

    def _athletes(self, n: int, full: np.ndarray) -> dict:
        rng, v, s = self.rng, self.v, self.scale
        a = self._ids(n, 3)  # entity, name literal, homepage literal
        team = self.team_base + 2 * rng.integers(0, s.n_teams, n)
        has_goals = full | (rng.random(n) < 0.7)
        has_home = rng.random(n) < 0.3
        parts = [
            rows_of(a, v[A], v["dbo:SoccerPlayer"]),
            rows_of(a, v["foaf:name"], a + 1),
            rows_of(a, v["dbo:team"], team),
            rows_of(a[has_goals], v["dbp:goals"], self.num + rng.integers(0, 300, n)[has_goals]),
            rows_of(a[has_home], v["foaf:homepage"], a[has_home] + 2),
        ]
        return {"ids": a, "rows": np.concatenate(parts), "team_rows": rows_of(team, v["rdfs:label"], team + 1)}

    def _places(self, n: int, full: np.ndarray) -> np.ndarray:
        rng, v = self.rng, self.v
        p = self._ids(n, 3)  # entity, label literal, abstract literal
        has_abs = full | (rng.random(n) < 0.8)
        has_subj = rng.random(n) < 0.5
        return np.concatenate([
            rows_of(p, v[A], v["dbo:Place"]),
            rows_of(p, v["rdfs:label"], p + 1),
            rows_of(p, v["wgs:lat"], self.lat + rng.integers(0, self.n_lat, n)),
            rows_of(p, v["wgs:long"], self.long + rng.integers(0, self.n_long, n)),
            rows_of(p[has_abs], v["dbo:abstract"], p[has_abs] + 2),
            rows_of(p[has_subj], v["dcterms:subject"], self.cat + rng.integers(0, N_CATEGORIES, n)[has_subj]),
        ])

    def _others(self, n: int, k=None) -> np.ndarray:
        rng, v = self.rng, self.v
        o = self._ids(n, 2)  # entity, name literal
        cls = np.where(rng.random(n) < 0.5, v["foaf:Person"], v["dbo:Work"])
        k = rng.integers(1, 5, n) if k is None else k
        props = [
            rows_of(o[k > j], v[f"dbp:prop{j}"], self.num + rng.integers(0, 1000, n)[k > j])
            for j in range(4)
        ]
        return np.concatenate([rows_of(o, v[A], cls), rows_of(o, v["foaf:name"], o + 1), *props])

    def changeset(self):
        rng, s, v = self.rng, self.scale, self.v
        live = np.flatnonzero(self.alive[: self.size])
        rm = rng.choice(live, size=min(s.removes, live.shape[0]), replace=False)
        n_ath, n_pl = int(s.adds * 0.02), int(s.adds * 0.06)
        m_a = max(1, n_ath // 4)
        ath = self._athletes(m_a, rng.random(m_a) < 0.5)
        m_p = max(1, n_pl // 5)
        adds = [ath["rows"], ath["team_rows"], self._places(m_p, rng.random(m_p) < 0.5)]
        # goal updates for existing athletes (remove + add)
        picks = np.unique(rng.integers(0, s.n_athletes, max(1, n_ath // 2)))
        old = self.goals_at[picks]
        rm = np.concatenate([rm, old[self.alive[old]]])
        adds.append(rows_of(self.athletes[picks], v["dbp:goals"], self.num + rng.integers(0, 300, picks.shape[0])))
        # bulk uninteresting churn up to the changeset's size
        have = sum(x.shape[0] for x in adds)
        if have < s.adds:
            k = rng.integers(1, 5, (s.adds - have) // 3 + 1)
            m_o = int(np.searchsorted(np.cumsum(2 + k), s.adds - have)) + 1
            adds.append(self._others(m_o, k[:m_o]))

        rm = np.unique(rm)
        removes = unique_rows(self.pool[rm])
        adds = unique_rows(np.concatenate(adds))
        adds = adds[~np.isin(as_records(adds), as_records(removes))]
        self.alive[rm] = False
        # team labels are live dump rows: a changeset adds them again, as the
        # string generator does, but the pool keeps one copy
        team_label = (adds[:, 1] == v["rdfs:label"]) & (adds[:, 0] >= self.team_base) & (
            adds[:, 0] < self.team_base + 2 * s.n_teams)
        fresh = adds[~team_label]
        new_goals = fresh[:, 1] == v["dbp:goals"]
        n_new = fresh.shape[0]
        check(self.size + n_new <= self.pool.shape[0], "id-space pool capacity")
        self.pool[self.size: self.size + n_new] = fresh
        self.alive[self.size: self.size + n_new] = True
        # point updated athletes at their new goals rows
        pos = {int(a): i for i, a in enumerate(self.athletes[picks])}
        for off in np.flatnonzero(new_goals):
            i = pos.get(int(fresh[off, 0]))
            if i is not None:
                self.goals_at[picks[i]] = self.size + off
        self.size += n_new
        return removes, adds


# ---------------------------------------------------------------------------
# phase helpers
# ---------------------------------------------------------------------------

def exprs(tcore):
    return {
        "football": tcore.InterestExpr.parse("synthetic://dbpedia-live", "local://football", *FOOTBALL),
        "location": tcore.InterestExpr.parse("synthetic://dbpedia-live", "local://location", *LOCATION),
    }


@contextlib.contextmanager
def plain_probe():
    """Route the engine's lexicographic probes to the plain version on the card.

    Used only for the comparison run; the bitset goes plain through the
    engine's ``matcher`` argument.
    """
    from repro_torch.kernels import ops, ref

    def merge_probe_plain(store, queries, side="left", hi_queries=None):
        if side == "left":
            return ref.merge_probe_ref(store, queries)
        if side == "range":
            return ref.merge_probe_range_ref(store, queries, hi_queries)
        return ref.merge_probe_right_ref(store, queries), None

    saved = ops.merge_probe
    ops.merge_probe = merge_probe_plain
    try:
        yield
    finally:
        ops.merge_probe = saved


def store_valid(store) -> bool:
    """Lex-sorted distinct rows, then PAD rows, with ``n`` the valid count."""
    import torch
    from repro_torch.core.triples import PAD, lex_less

    spo, n = store.spo, int(store.n)
    valid = spo[:, 0] != PAD
    ok = int(valid.sum()) == n and bool(valid[:n].all())
    if n > 1:
        ok = ok and bool(lex_less(spo[: n - 1], spo[1:n]).all())
    return ok and bool((spo[n:] == PAD).all()) and spo.dtype == torch.int32


def stores_of(sub):
    out = sub.last_outputs
    return {**{f: getattr(out, f) for f in OUT_FIELDS}, "tau": sub.tau, "rho": sub.rho}


def drive(tcore, dictionary, inits, changesets, caps, device, matcher=None):
    """Register both interests and stream the changesets through ``IrapEngine``."""
    engine = tcore.IrapEngine(dictionary, device=device)
    subs = {
        name: engine.register_interest(expr, caps[name], initial_target=inits[name], matcher=matcher)
        for name, expr in exprs(tcore).items()
    }
    steps = []
    for d_np, a_np in changesets:
        stats = engine.process_changeset(d_np, a_np)
        steps.append({
            "stats": {st_name: st for st_name, st in zip(subs, stats)},
            "stores": {name: stores_of(sub) for name, sub in subs.items()},
        })
    return subs, steps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    import torch

    global INT_OPS_PER_S
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = sms * INT32_LANES_PER_SM * mhz * 1e6
    log(f"int32 peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = {INT_OPS_PER_S:.3e} operations/s")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, parallel)")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def phase_kernels(device):
    import torch
    from repro_torch.kernels import merge_join, ref, triple_match

    rng = np.random.default_rng(1)
    pad = np.iinfo(np.int32).max
    cases = 0
    for n, n_pat, vocab in [(1, 1, 3), (4095, 3, 9), (4097, 32, 5), (1 << 20, 6, 1000), (7, 0, 3)]:
        spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
        spo[rng.random(n) < 0.1] = pad
        pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
        if n_pat:
            pats[-1] = -1  # wildcard-only; with 32 patterns it sets bit 31
        got = triple_match.triple_match_cuda(torch.as_tensor(spo, device=device),
                                             torch.as_tensor(pats, device=device))
        want = ref.pattern_bitmask_ref(torch.as_tensor(spo, device=device),
                                       torch.as_tensor(pats, device=device))
        check(torch.equal(got, want), f"triple_match != plain at n={n} P={n_pat}")
        if n_pat == 32:
            valid = torch.as_tensor(spo[:, 0] != pad, device=device)
            check(bool((got[valid] < 0).all()), "bit 31 set on every valid row")
        cases += 1
    # the row stream's edges: N % 4 of 1, 2 and 3 (scalar tail), bases offset
    # by 1, 2 and 3 rows (scalar head, unaligned stores), P of 0, 1 and 32,
    # all-PAD rows
    for n, n_pat, offset, all_pad in [(4097, 1, 0, False), (4098, 32, 1, False), (4099, 0, 0, False),
                                      (1026, 32, 2, False), (100_001, 6, 3, False), (4096, 5, 0, True),
                                      (3, 32, 1, False), (2, 1, 2, False)]:
        spo = rng.integers(0, 5, size=(n + offset, 3)).astype(np.int32)
        spo[rng.random(n + offset) < 0.1] = pad
        if all_pad:
            spo[:] = pad
        pats = rng.integers(-1, 5, size=(n_pat, 3)).astype(np.int32)
        if n_pat:
            pats[-1] = -1
        t_spo, t_pats = torch.as_tensor(spo, device=device)[offset:], torch.as_tensor(pats, device=device)
        got = triple_match.triple_match_cuda(t_spo, t_pats)
        check(torch.equal(got, ref.pattern_bitmask_ref(t_spo, t_pats)),
              f"triple_match != plain at n={n} P={n_pat} offset={offset} all_pad={all_pad}")
        cases += 1
    for s_rows, q_rows, vocab, skew in [(1, 5, 3, False), (3000, 5000, 30, False),
                                        (200_000, 300_000, 200, False), (200_000, 300_000, 200, True)]:
        rows = np.unique(rng.integers(0, vocab, size=(s_rows, 3)).astype(np.int32), axis=0)
        store = np.full((2 * rows.shape[0], 3), pad, np.int32)
        store[: rows.shape[0]] = rows
        if skew:  # every query in one narrow region of the store
            queries = np.repeat(rows[1000:1004], q_rows // 4, axis=0)
        else:  # present (duplicated), absent and PAD queries
            queries = np.concatenate([rows[rng.integers(0, rows.shape[0], q_rows // 2)],
                                      rng.integers(0, vocab + 3, size=(q_rows // 2, 3)).astype(np.int32),
                                      np.full((2, 3), pad, np.int32)])
        st, qu = torch.as_tensor(store, device=device), torch.as_tensor(queries, device=device)
        idx, found = merge_join.merge_probe_cuda(st, qu, "left")
        w_idx, w_found = ref.merge_probe_ref(st, qu)
        check(torch.equal(idx, w_idx) and torch.equal(found, w_found), f"merge_probe left != plain ({s_rows}, {q_rows})")
        r_idx, none = merge_join.merge_probe_cuda(st, qu, "right")
        check(none is None and torch.equal(r_idx, ref.merge_probe_right_ref(st, qu)),
              f"merge_probe right != plain ({s_rows}, {q_rows})")
        cases += 2
    cases += probe_kernel_cases(device, rng)
    cases += bank_kernel_cases(device, rng)
    cases += chain_kernel_cases(device, rng)
    cases += block_kernel_cases(device, rng)
    torch.cuda.synchronize()
    log(f"kernels: {cases} kernel-vs-plain cases bit-identical on the card")


PROBE_CASES = ("sorted", "all_equal", "window-1", "window", "window+1", "oversized", "unsorted", "mixed",
               "int32_min", "s0", "s1")


def probe_case(name: str, rng, tile: int, w_max: int):
    """(store, lo queries, hi queries, the tile paths the left side takes)
    for K2/K3's tile paths. The hi queries keep a prefix of each lo query's
    columns (mixed depths for the unsorted case) and PAD past it, as
    prefix_range builds them."""
    pad = np.iinfo(np.int32).max
    n = 20_000
    rows = np.stack([np.arange(n) // 100, np.arange(n) % 100, np.zeros(n, np.int64)], 1).astype(np.int32)
    store = np.full((n + 4096, 3), pad, np.int32)
    store[:n] = rows
    paths = {"window"}
    if name == "sorted":  # a PAD tail, Q not a multiple of the tile
        q = np.concatenate([store[np.sort(rng.integers(0, 3000, 3 * tile + 77))], np.full((tile + 5, 3), pad, np.int32)])
        paths = {"window", "oversized"}  # the tile across the PAD boundary spans the store's rest
    elif name == "all_equal":
        q = np.repeat(store[n + 7: n + 8], 2 * tile + 3, axis=0)
    elif name.startswith("window"):  # left(first) .. left(last) is w rows, and one more is read
        w = w_max + {"window-1": -1, "window": 0, "window+1": 1}[name]
        q = store[np.sort(np.concatenate([[5000, 5000 + w - 1], rng.integers(5000, 5000 + w, tile - 2)]))]
        paths = {"window" if w <= w_max else "oversized"}
    elif name == "oversized":
        q = store[np.sort(rng.integers(0, n, 4 * tile))]
        q[::3, 2] = 1  # absent rows
        q = q[np.lexsort((q[:, 2], q[:, 1], q[:, 0]))]
        paths = {"oversized"}
    elif name == "unsorted":
        q = rng.integers(-2, 210, size=(3 * tile + 9, 3)).astype(np.int32)
        q[::11] = pad
        paths = {"unsorted"}
    elif name == "mixed":  # sorted tiles with a shuffled one between them
        q = store[np.sort(rng.integers(0, 1500, 3 * tile))]
        q[tile: 2 * tile] = q[tile: 2 * tile][rng.permutation(tile)]
        paths = {"window", "unsorted"}
    elif name == "int32_min":  # a subject prefix: the window holds the subjects' rows
        q = store[np.sort(rng.integers(0, 1500, 2 * tile))]
        q[:, 1:] = np.iinfo(np.int32).min
    elif name == "s0":
        store, q = store[:0], rng.integers(0, 5, size=(9, 3)).astype(np.int32)
        paths = {"unsorted"}
    elif name == "s1":
        store, q = store[:1], np.concatenate([store[:1], rng.integers(-1, 3, size=(9, 3)).astype(np.int32)])
        paths = {"unsorted"}
    else:
        raise KeyError(name)
    depth = rng.integers(1, 4, q.shape[0])[:, None] if name == "unsorted" else (1 if name == "int32_min" else 3)
    hi = np.where(np.arange(3)[None, :] < depth, q, pad).astype(np.int32)
    return store, q.astype(np.int32), hi, paths


def probe_kernel_cases(device, rng) -> int:
    """K2/K3 at each tile path of the kernel, left, right and range, bit for
    bit against the plain versions; the tile counts name the paths taken."""
    import torch
    from repro_torch.kernels import merge_join, ref

    cases = 0
    for name in PROBE_CASES:
        store, lo, hi, paths = probe_case(name, rng, merge_join.TILE, merge_join.WINDOW_ROWS)
        st, lq, hq = (torch.as_tensor(a, device=device) for a in (store, lo, hi))
        n_tiles = -(-lo.shape[0] // merge_join.TILE)
        for side in ("left", "right", "range"):
            counts = torch.zeros(3, dtype=torch.int32, device=device)
            if side == "range":
                got = merge_join.merge_probe_range_cuda(st, lq, hq, tile_counts=counts)
                want = ref.merge_probe_range_ref(st, lq, hq)
            elif side == "left":
                got = merge_join.merge_probe_cuda(st, lq, "left", tile_counts=counts)
                want = ref.merge_probe_ref(st, lq)
            else:
                got = merge_join.merge_probe_cuda(st, lq, "right", tile_counts=counts)[:1]
                want = (ref.merge_probe_right_ref(st, lq),)
            check(all(torch.equal(g, w) for g, w in zip(got, want)), f"merge_probe {side} != plain ({name})")
            c = counts.tolist()
            check(sum(c) == n_tiles, f"merge_probe {side} ({name}): tile counts {c} for {n_tiles} tiles")
            if side == "left":
                took = {p for p, k in zip(merge_join.TILE_PATHS, c) if k}
                check(took == paths, f"merge_probe left ({name}): paths {took}, expected {paths}")
            cases += 1
    return cases


def bank_kernel_cases(device, rng) -> int:
    """K4 (bank words) and K5 (fused lane bits) against their plain versions:
    W = 1, 2 and 5; P not a multiple of 32 with bit 31 set; all-PAD bank rows
    and PAD rows; 1, 4095, 4097 and ~10^5 rows; inactive members; nt = 1 and
    32; lanes in the last word. Then K4 at BANK_CASES, the slot-mask
    design's paths, and K5 at LANES_EDGE_CASES, its row stream's paths."""
    import torch
    from repro_torch.kernels import ref, triple_match_lanes, triple_match_words

    pad = np.iinfo(np.int32).max
    cases = 0

    def bank(n_pat, vocab, dead):
        pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
        if n_pat:
            pats[-1] = -1  # wildcard-only: the top bit of its word on every valid row
        pats[list(dead)] = pad  # tombstones and padding
        return pats

    def rows(shape, vocab):
        spo = rng.integers(0, vocab, size=(*shape, 3)).astype(np.int32)
        spo[rng.random(shape) < 0.1] = pad
        return spo

    for n, n_pat, vocab, dead in [(1, 7, 3, ()), (4095, 32, 4, (3,)), (4097, 45, 5, (0, 40)),
                                  (100_003, 160, 6, (31, 63, 100)), (4097, 64, 4, range(32, 63)),
                                  (9, 0, 3, ())]:
        spo = torch.as_tensor(rows((n,), vocab), device=device)
        pats = torch.as_tensor(bank(n_pat, vocab, dead).reshape(-1, 3), device=device)
        got = triple_match_words.triple_match_words_cuda(spo, pats)
        want = ref.pattern_bitmask_words_ref(spo, pats)
        check(torch.equal(got, want), f"triple_match_words != plain at n={n} P={n_pat}")
        if n_pat and n_pat % 32 == 0:
            check(bool((got[spo[:, 0] != pad, -1] < 0).all()), "bit 31 of the last word on every valid row")
        cases += 1
    for n, n_pat, offset, kind, all_pad in BANK_CASES:
        spo_np, pats_np = bank_case(rng, n + offset, n_pat, kind)
        if all_pad:
            spo_np[:] = pad
        spo = torch.as_tensor(spo_np, device=device)[offset:]  # contiguous, its base offset by whole rows
        pats = torch.as_tensor(pats_np, device=device)
        got = triple_match_words.triple_match_words_cuda(spo, pats)
        check(torch.equal(got, ref.pattern_bitmask_words_ref(spo, pats)),
              f"triple_match_words != plain at n={n} P={n_pat} offset={offset} bank={kind} all_pad={all_pad}")
        cases += 1
    for r, n, n_pat, nt, inactive in [(2, 1, 32, 1, ()), (3, 4095, 64, 32, (1,)), (4, 4097, 160, 6, (0, 3)),
                                      (5, 100_003, 64, 3, (2, 4)), (2, 17, 32, 4, (0, 1))]:
        spo_b = torch.as_tensor(rows((r, n), 4), device=device)
        pats_np = bank(n_pat, 4, (n_pat // 2,))
        lanes_np = rng.integers(0, n_pat, size=(r, nt)).astype(np.int32)
        lanes_np[:, -1] = n_pat - 1  # a lane in the last word
        active_np = np.ones(r, bool)
        active_np[list(inactive)] = False
        pats, lanes = torch.as_tensor(pats_np, device=device), torch.as_tensor(lanes_np, device=device)
        active = torch.as_tensor(active_np, device=device)
        got = triple_match_lanes.triple_match_lanes_cuda(spo_b, pats, lanes, active)
        want = ref.pattern_lane_bits_ref(spo_b, pats, lanes, active)
        check(torch.equal(got, want), f"triple_match_lanes != plain at R={r} n={n} nt={nt}")
        check(bool((got[torch.as_tensor(~active_np, device=device)] == 0).all()), "inactive members give 0")
        cases += 1
    for r, n, n_pat, nt, offset, inactive, kind in LANES_EDGE_CASES:
        rows_np, pats_np, lanes_np, active_np = lanes_case(rng, r, n, n_pat, nt, offset, inactive, kind)
        spo_b = torch.as_tensor(rows_np, device=device)[offset:].view(r, n, 3)  # its base offset by whole rows
        pats, lanes = torch.as_tensor(pats_np, device=device), torch.as_tensor(lanes_np, device=device)
        active = torch.as_tensor(active_np, device=device)
        got = triple_match_lanes.triple_match_lanes_cuda(spo_b, pats, lanes, active)
        check(torch.equal(got, ref.pattern_lane_bits_ref(spo_b, pats, lanes, active)),
              f"triple_match_lanes != plain at R={r} n={n} P={n_pat} nt={nt} offset={offset} kind={kind}")
        cases += 1
    return cases


def chain_kernel_cases(device, rng) -> int:
    """K6 (segmented words) and K7 (lane refine) against their plain
    versions. K6: 1, 2 and 32 segments; seg bits above n_seg; W = 1, 2 and
    5 (banks of 33 and 160 patterns); an all-tombstone word; PAD rows; row
    counts off the block size; and SEG_BANK_CASES, the slot-mask design's
    paths. K7: Vp = 1, 31, 32, 33 and 64; dead slots;
    parents in the first and the last word; wildcard residuals; PAD rows;
    one plane, planes sharing one row set, planes with their own rows; and
    REFINE_CASES, the slot-mask design's paths."""
    import torch
    from repro_torch.kernels import lane_refine, ref, triple_match_words_segmented

    pad = np.iinfo(np.int32).max
    cases = 0

    def rows(shape, vocab):
        spo = rng.integers(0, vocab, size=(*shape, 3)).astype(np.int32)
        spo[rng.random(shape) < 0.1] = pad
        return torch.as_tensor(spo, device=device)

    for n, n_pat, dead, n_seg, bits in [(1, 7, (), 1, 2), (4095, 33, (0,), 2, 5), (4097, 32, (), 2, 2),
                                        (100_003, 160, (31, 100), 32, 32), (4097, 64, range(32, 64), 32, 30),
                                        (9, 0, (), 3, 3)]:
        spo = rows((n,), 5)
        pats = rng.integers(-1, 5, size=(n_pat, 3)).astype(np.int32)
        if n_pat:
            pats[-1] = -1
        pats[list(dead)] = pad
        pats = torch.as_tensor(pats.reshape(-1, 3), device=device)
        seg = rng.integers(-(1 << 31), (1 << 31) - 1, size=n).astype(np.int32)
        if bits < 32:
            seg &= (1 << bits) - 1  # bits above n_seg are ignored
        seg = torch.as_tensor(seg, device=device)
        got = triple_match_words_segmented.triple_match_words_segmented_cuda(spo, pats, seg, n_seg)
        want = ref.pattern_bitmask_words_segmented_ref(spo, pats, seg, n_seg)
        check(torch.equal(got, want), f"triple_match_words_segmented != plain at n={n} P={n_pat} n_seg={n_seg}")
        cases += 1
    for n, n_pat, offset, kind, all_pad, n_seg, bits in SEG_BANK_CASES:
        spo_np, pats_np = bank_case(rng, n + offset, n_pat, kind)
        if all_pad:
            spo_np[:] = pad
        seg = rng.integers(-(1 << 31), (1 << 31) - 1, size=n + 4).astype(np.int32)
        if bits < 32:
            seg &= (1 << bits) - 1
        seg[rng.random(n + 4) < 0.2] = 0  # rows of no segment
        seg_offset = (offset + 1) % 4  # seg's base off the rows' alignment
        spo = torch.as_tensor(spo_np, device=device)[offset:]
        pats = torch.as_tensor(pats_np, device=device)
        seg = torch.as_tensor(seg, device=device)[seg_offset:seg_offset + n]
        got = triple_match_words_segmented.triple_match_words_segmented_cuda(spo, pats, seg, n_seg)
        check(torch.equal(got, ref.pattern_bitmask_words_segmented_ref(spo, pats, seg, n_seg)),
              f"triple_match_words_segmented != plain at n={n} P={n_pat} offset={offset} bank={kind} "
              f"all_pad={all_pad} n_seg={n_seg}")
        cases += 1
    for n, n_pat, vp, n_virt, planes, shared in [(1, 7, 1, 1, 1, True), (4097, 64, 31, 20, 2, True),
                                                 (4095, 64, 32, 32, 3, False), (100_003, 160, 33, 9, 2, True),
                                                 (4097, 32, 64, 40, 32, False), (17, 40, 64, 0, 1, True),
                                                 (4097, 300, 64, 30, 2, True)]:
        spo = rows((n,) if shared else (planes, n), 5)
        pats = rng.integers(-1, 5, size=(n_pat, 3)).astype(np.int32)
        pats[-1] = -1
        t_pats = torch.as_tensor(pats, device=device)
        words = torch.stack([ref.pattern_bitmask_words_ref(spo if shared else spo[f], t_pats) for f in range(planes)])
        words = torch.where(torch.as_tensor(rng.random((planes, n)) < 0.8, device=device)[..., None], words,
                            torch.zeros_like(words))  # masked planes, as K6 gives them
        parents = np.full(vp, -1, np.int32)
        residual = np.full((vp, 3), pad, np.int32)
        for i, v in enumerate(rng.choice(vp, size=n_virt, replace=False)):
            par = (0, n_pat - 1)[i] if i < 2 else int(rng.integers(0, n_pat))  # first and last word
            parents[v] = par
            residual[v] = [rng.integers(0, 5) if pats[par, k] == -1 and rng.random() < 0.7 else -1 for k in range(3)]
        args = (spo, words if planes > 1 else words[0], torch.as_tensor(parents, device=device),
                torch.as_tensor(residual, device=device))
        if planes == 1 and not shared:
            args = (spo[0],) + args[1:]
        got = lane_refine.lane_refine_cuda(*args)
        check(torch.equal(got, ref.lane_refine_ref(*args)),
              f"lane_refine != plain at n={n} Vp={vp} planes={planes} shared={shared}")
        cases += 1
    for n, w, vp, planes, shared, n_const, vocab, positions in REFINE_CASES:
        args = [torch.as_tensor(x, device=device)
                for x in refine_case(rng, n, w, vp, planes, shared, n_const, vocab, positions)]
        got = lane_refine.lane_refine_cuda(*args)
        check(torch.equal(got, ref.lane_refine_ref(*args)),
              f"lane_refine != plain at n={n} W={w} Vp={vp} planes={planes} shared={shared} constants={n_const}")
        cases += 1
    return cases


# K4's and K6's slot-mask paths, (n, P, base offset in rows, bank kind, all-PAD
# rows): W = 1, 2, 5 and 10; 320 distinct constants at one position (three
# chunks of tables); bases offset by 1-3 rows and N % 4 of 1-3 (the scalar
# head and tail, unaligned stores); N below one group of 4 rows; an all-PAD
# row set. K6 adds (n_seg, seg bits drawn): 1, 2, 3 and 32 segments, bits
# above n_seg.
# The sharded cohort step's block-sliced views, (shards, rows): shard i's
# block of blk = ceil(rows / shards) rows starts at min(i blk, rows - blk);
# 4 shards divide the rows, 3 do not (the last block overlaps the one before)
BLOCK_CASES = [(4, 1 << 17), (3, (1 << 17) + 1)]


def block_kernel_cases(device, rng) -> int:
    """K4, K5 and K6 at the sharded step's block-sliced views of a D side
    (two frontier planes), a cohort's I rows (8 members, two inactive) and a
    chain's union rows (two segments), over a bank of 96 rows (W = 3): each
    block against the plain version on the same view, then the blocks
    stitched at their starts against the plain version over every row."""
    import torch
    from repro_torch.core.broker import _blocks, _stitch
    from repro_torch.kernels import ref, triple_match_lanes, triple_match_words, triple_match_words_segmented

    cases = 0
    for n_shards, cap in BLOCK_CASES:
        blk, starts = _blocks(cap, n_shards)
        spo_np, pats_np = bank_case(rng, 2 * cap, 96, "mixed")
        d_spo = torch.as_tensor(spo_np, device=device).view(2, cap, 3)
        pats = torch.as_tensor(pats_np, device=device)
        seg = torch.as_tensor(rng.integers(0, 4, size=cap).astype(np.int32), device=device)
        lanes = torch.as_tensor(rng.integers(0, 96, size=(8, 3)).astype(np.int32), device=device)
        active = torch.as_tensor(np.arange(8) % 4 != 3, device=device)
        i_spo = d_spo[torch.as_tensor(rng.integers(0, 2, size=8), device=device)]
        blocks = {"words": [], "lanes": [], "seg": []}
        for start in starts:
            sl = slice(start, start + blk)
            d_loc = d_spo[:, sl].reshape(-1, 3)
            w = triple_match_words.triple_match_words_cuda(d_loc, pats)
            check(torch.equal(w, ref.pattern_bitmask_words_ref(d_loc, pats)),
                  f"triple_match_words != plain at the block at {start} of {cap} rows ({n_shards} shards)")
            a = triple_match_lanes.triple_match_lanes_cuda(i_spo[:, sl], pats, lanes, active)
            check(torch.equal(a, ref.pattern_lane_bits_ref(i_spo[:, sl], pats, lanes, active)),
                  f"triple_match_lanes != plain at the block at {start} of {cap} rows ({n_shards} shards)")
            g = triple_match_words_segmented.triple_match_words_segmented_cuda(d_spo[0, sl], pats, seg[sl], 2)
            check(torch.equal(g, ref.pattern_bitmask_words_segmented_ref(d_spo[0, sl], pats, seg[sl], 2)),
                  f"triple_match_words_segmented != plain at the block at {start} of {cap} rows ({n_shards} shards)")
            blocks["words"].append(w.view(2, blk, -1))
            blocks["lanes"].append(a)
            blocks["seg"].append(g)
        wants = {"words": ref.pattern_bitmask_words_ref(d_spo.reshape(-1, 3), pats).view(2, cap, -1),
                 "lanes": ref.pattern_lane_bits_ref(i_spo, pats, lanes, active),
                 "seg": ref.pattern_bitmask_words_segmented_ref(d_spo[0], pats, seg, 2)}
        for name, want in wants.items():
            check(torch.equal(_stitch(torch.stack(blocks[name]), cap, blk, starts, dim=1), want),
                  f"the stitched {name} blocks != one plain pass over {cap} rows ({n_shards} shards)")
        cases += 3
    return cases


BANK_CASES = [(4097, 32, 0, "shared", False), (4098, 64, 1, "wild", False), (4099, 160, 2, "pad", False),
              (20_001, 320, 3, "distinct", False), (3, 7, 1, "mixed", False), (4096, 45, 0, "mixed", True),
              (2, 1, 2, "wild", False), (100_003, 9, 0, "pad", False), (1001, 300, 1, "shared", False)]
SEG_BANK_CASES = [case + seg for case, seg in zip(BANK_CASES, [(1, 3), (2, 2), (32, 32), (2, 5), (32, 30), (3, 3),
                                                               (1, 1), (2, 2), (3, 32)])]


def bank_case(rng, n, n_pat, kind):
    """Rows and a bank for the bank-words kernels' slot-mask paths. ``kind``:
    "shared" (every slot's p is one constant), "distinct" (wildcards but for
    distinct o-constants from a vocabulary of 10^6: more than one table of
    128 slots holds once P > 128), "wild" (every third slot wildcard-only),
    "pad" (every fourth slot all-PAD, the next one PAD at one position) or
    "mixed" (random terms); half of the rows carry some slot's constants, so
    that rows PAD at p or o meet the slots PAD there, and a tenth are PAD."""
    pad = np.iinfo(np.int32).max
    vocab = 10 ** 6 if kind == "distinct" else 6
    pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
    if kind == "shared":
        pats[:, 1] = 3
    elif kind == "distinct":
        pats[:, :2] = -1
        pats[:, 2] = rng.choice(vocab, size=n_pat, replace=False)
    elif kind == "wild":
        pats[::3] = -1
    elif kind == "pad":
        pats[::4] = pad
        for j in range(1, n_pat, 4):
            pats[j, rng.integers(0, 3)] = pad
    spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
    if n_pat:
        hit = rng.random(n) < 0.5
        src = pats[rng.integers(0, n_pat, size=int(hit.sum()))]
        spo[hit] = np.where(src == -1, spo[hit], src)
    spo[rng.random(n) < 0.1] = pad
    return spo, pats


# K5's row-stream paths, (members, rows, bank rows, nt, base offset in rows,
# inactive members, kind): N % 4 of 1, 2 and 3 (each member its own
# alignment: scalar heads and tails, unaligned stores); N < 4; bases offset
# by a row, and a cohort sliced along R (spo_b[1:] of one more member); nt = 0
# and 32; lanes outside the bank; every member inactive; more members than
# the grid holds blocks, in six staging chunks; R nt = 1,280 (two chunks)
LANES_EDGE_CASES = [(5, 4097, 64, 3, 0, (1,), "sorted"), (4, 4098, 32, 6, 0, (), "random"),
                    (6, 4099, 45, 32, 0, (0, 5), "sorted"), (3, 3, 32, 4, 0, (), "random"),
                    (2, 1, 7, 2, 1, (), "random"), (5, 4096, 64, 3, 1, (2,), "sorted"),
                    (4, 4097, 40, 5, 4097, (3,), "random"), (3, 1000, 32, 0, 0, (), "random"),
                    (4, 4096, 40, 8, 0, (), "lanes_out"), (4, 2048, 32, 32, 0, (0, 1, 2, 3), "random"),
                    (2000, 1001, 32, 3, 0, tuple(range(1, 2000, 3)), "random"),
                    (40, 1001, 64, 32, 2, (3, 39), "sorted")]


def lanes_case(rng, r, n, n_pat, nt, offset, inactive, kind):
    """A cohort for K5's row stream: rows int32[offset + r n, 3] (the cohort
    is ``rows[offset:]`` seen as [r, n, 3]), a bank with all-wildcard rows and
    all-PAD rows (tombstones, padding), lanes and a member mask. Half of the
    rows carry a routed bank row's constants and a tenth are PAD. ``kind``:
    "random" rows; "sorted" (each member's rows a lex-sorted set with a PAD
    tail, as the broker stacks its stores; member 0 all PAD); "lanes_out" (a
    third of the lanes below 0, or at and past n_pat, where they match
    nothing)."""
    pad = np.iinfo(np.int32).max
    pats = rng.integers(-1, 6, size=(n_pat, 3)).astype(np.int32)
    pats[::5] = -1
    pats[1::7] = pad
    lanes = rng.integers(0, n_pat, size=(r, nt)).astype(np.int32)
    if kind == "lanes_out":
        out = rng.random((r, nt)) < 1 / 3
        far = np.array([-(1 << 31), -33, -1, n_pat, n_pat + 1, 32 * -(-n_pat // 32), 1 << 30], np.int32)
        lanes[out] = rng.choice(far, size=int(out.sum()))
    spo = rng.integers(0, 1000, size=(r, n, 3)).astype(np.int32)
    if n_pat and nt:
        hit = rng.random((r, n)) < 0.5
        src = pats[np.clip(lanes[np.nonzero(hit)[0], rng.integers(0, nt, size=int(hit.sum()))], 0, n_pat - 1)]
        spo[hit] = np.where(src == -1, spo[hit], src)
    spo[rng.random((r, n)) < 0.1] = pad
    if kind == "sorted":
        for k in range(r):
            rows = np.unique(spo[k][(spo[k] != pad).all(axis=1)], axis=0)
            n_valid = 0 if k == 0 else int(rng.integers(rows.shape[0] // 2, rows.shape[0] + 1))
            spo[k, :n_valid] = rows[:n_valid]
            spo[k, n_valid:] = pad
    rows = np.concatenate([rng.integers(0, 1000, size=(offset, 3)).astype(np.int32), spo.reshape(-1, 3)])
    active = np.ones(r, bool)
    active[list(inactive)] = False
    return rows, pats, lanes, active


# K7's slot-mask paths, (n, W, Vp, planes, shared rows, constants a slot,
# vocabulary, residual positions): two and three constants; 600 distinct
# o-constants from a vocabulary of 10^6 (more than one table holds); Vp of
# 192-256, several chunks of output words (vector and scalar stores); W = 10;
# F = 1, 2 and 32, shared and per-plane rows; N below one block; Vp = 0
REFINE_CASES = [(4097, 1, 64, 2, True, 2, 5, (0, 1, 2)), (4097, 2, 64, 2, False, 3, 5, (0, 1, 2)),
                (20_000, 10, 600, 2, True, 1, 10 ** 6, (2,)), (4097, 3, 200, 3, True, None, 7, (0, 1, 2)),
                (4097, 2, 256, 2, False, None, 4, (0, 1, 2)), (4097, 2, 192, 2, True, 2, 4, (0, 1, 2)),
                (4097, 10, 40, 2, False, None, 5, (0, 1, 2)), (1000, 1, 33, 32, True, None, 5, (0, 1, 2)),
                (1000, 1, 33, 32, False, None, 5, (0, 1, 2)), (100, 2, 31, 1, False, None, 5, (0, 1, 2)),
                (100, 2, 31, 1, True, None, 5, (0, 1, 2)), (17, 1, 0, 2, True, None, 5, (0, 1, 2))]


def refine_case(rng, n, w, vp, planes, shared, n_const, vocab, positions=(0, 1, 2)):
    """Random lane_refine inputs: int32[F, N, W] real words of random bits
    (a fifth of the rows zeroed), a fifth of the slots dead (parents -1, -5,
    32 W and beyond), ``n_const`` residual constants a slot at ``positions``
    (random 0-3 when None), and half of the rows carrying some slot's
    constants so that the compares hit."""
    pad = np.iinfo(np.int32).max
    spo = rng.integers(0, vocab, size=((n,) if shared else (planes, n)) + (3,)).astype(np.int32)
    parents = rng.integers(0, 32 * w, size=vp).astype(np.int32)
    dead = rng.random(vp) < 0.2
    parents[dead] = rng.choice(np.array([-1, -5, 32 * w, 32 * w + 7], np.int32), size=int(dead.sum()))
    residual = np.full((vp, 3), -1, np.int32)
    for v in range(vp):
        c = int(rng.integers(0, len(positions) + 1)) if n_const is None else n_const
        residual[v, rng.choice(positions, size=c, replace=False)] = rng.integers(0, vocab, size=c)
    flat = spo.reshape(-1, 3)
    if vp:
        hit = rng.random(flat.shape[0]) < 0.5
        src = residual[rng.integers(0, vp, size=int(hit.sum()))]
        flat[hit] = np.where(src == -1, flat[hit], src)
    flat[rng.random(flat.shape[0]) < 0.1] = pad
    words = rng.integers(-(1 << 31), 1 << 31, size=(planes, n, w), dtype=np.int64).astype(np.int32)
    words[rng.random((planes, n)) < 0.2] = 0
    return spo, words, parents, residual


def phase_small(tcore, device, seed):
    import torch
    from repro_torch.core.oracle import OracleEvaluator

    # the paper's running example (tests/test_paper_example.py)
    d = tcore.Dictionary()
    expr = tcore.InterestExpr.parse(
        source="http://live.dbpedia.org/changesets",
        target="http://localhost:3030/target/sparql",
        bgp=[("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?goals")],
        ogp=[("?a", "foaf:homepage", "?page")],
    )
    tau0 = d.encode_triples([
        ("dbr:Marcel", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
        ("dbr:Cristiano_Ronaldo", "foaf:homepage", '"http://cristianoronaldo.com"'),
    ])
    removed = d.encode_triples([
        ("dbr:Marcel", "dbp:goals", "1"),
        ("dbr:Marcel", "dbo:team", "dbr:FNFT"),
        ("dbr:Tim%02", "foaf:name", '"Tim Berners-Lee"'),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
    ])
    added = d.encode_triples([
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "216"),
        ("dbr:Barack_Obama", "foaf:name", '"Barack Obama"'),
        ("dbr:Barack_Obama", "foaf:homepage", '"http://www.barackobama.com/"'),
        ("dbr:Rio_Ferdinand", A, "foaf:Person"),
        ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
        ("dbr:Rio_Ferdinand", "dbp:goals", "10"),
        ("dbr:Arvid_Smit", A, "dbo:Athlete"),
    ])
    engine = tcore.IrapEngine(d, device=device)
    sub = engine.register_interest(
        expr, tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32), initial_target=tau0
    )
    check(sub.tau.spo.device.type == torch.device(device).type, "paper example runs on the card")
    plan = tcore.compile_interest(expr, d)
    as_set = lambda rows: {tuple(int(x) for x in r) for r in rows}  # noqa: E731
    tau_set, rho_set = as_set(tau0), set()
    for d_np, a_np in [(removed, added), (np.zeros((0, 3), np.int32),
                                          d.encode_triples([("dbr:Arvid_Smit", "dbp:goals", "3")]))]:
        out = sub.apply(d_np, a_np)
        want = OracleEvaluator(plan).step(as_set(d_np), as_set(a_np), tau_set, rho_set)
        got = {f: tcore.to_set(getattr(out, f)) for f in OUT_FIELDS}
        got.update(tau1=tcore.to_set(sub.tau), rho1=tcore.to_set(sub.rho))
        check(got == want, f"paper example differs from the oracle: {got} vs {want}")
        tau_set, rho_set = want["tau1"], want["rho1"]
    check(len(tau_set) == 7 and len(rho_set) == 2, "paper example: τ and ρ after the promotion")
    log("small: paper running example (2 changesets) equals the oracle on the card")

    # a small id-space stream, both interests, against the oracle
    Dict = make_dictionary_class()
    d = Dict()
    stream = IdSpaceStream(d, SMALL, seed, n_changesets=2)
    inits = {"football": stream.football_init, "location": stream.location_init}
    changesets = [stream.changeset() for _ in range(2)]
    big = tcore.StepCapacities(n_removed=512, n_added=512, tau=4096, rho=4096, pulls=4096, fanout=64,
                               dedup_candidates=4096)
    subs, steps = drive(tcore, d, inits, changesets, {"football": big, "location": big}, device)
    for name, sub in subs.items():
        orc = OracleEvaluator(sub.plan)
        tau_set, rho_set = as_set(inits[name]), set()
        for (d_np, a_np), step in zip(changesets, steps):
            want = orc.step(as_set(d_np), as_set(a_np), tau_set, rho_set)
            stores = step["stores"][name]
            for f, key in [*((f, f) for f in OUT_FIELDS), ("tau", "tau1"), ("rho", "rho1")]:
                check(tcore.to_set(stores[f]) == want[key], f"small stream {name}: {f} differs from the oracle")
            tau_set, rho_set = want["tau1"], want["rho1"]
        check(sub.rebuilds == 0, "small stream ran without reallocation")
    log(f"small: id-space stream ({len(changesets)} changesets, Football + Location) equals the oracle")

    # the same through the Broker: the paper's example with three interests
    # under three policies, then a small id-space stream with Football,
    # Location and 8 category interests under all four; each fire against the
    # oracle on the changeset composed since the subscriber's last fire
    d = tcore.Dictionary()
    tau0 = d.encode_triples([("dbr:Marcel", A, "dbo:Athlete"), ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
                             ("dbr:Cristiano_Ronaldo", "dbp:goals", "96")])
    paper_cs = [
        (d.encode_triples([("dbr:Marcel", "dbp:goals", "1"), ("dbr:Cristiano_Ronaldo", "dbp:goals", "96")]),
         d.encode_triples([("dbr:Cristiano_Ronaldo", "dbp:goals", "216"), ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
                           ("dbr:Rio_Ferdinand", "dbp:goals", "10"), ("dbr:FNFT", A, "dbo:Team")])),
        (np.zeros((0, 3), np.int32), d.encode_triples([("dbr:Arvid_Smit", A, "dbo:Athlete"),
                                                        ("dbr:X", "dbo:team", "dbr:FNFT")])),
        (d.encode_triples([("dbr:Rio_Ferdinand", "dbp:goals", "10")]),
         d.encode_triples([("dbr:Arvid_Smit", "dbp:goals", "3")])),
    ]
    caps = tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
    specs = [
        ("athlete", ([("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?g")], [("?a", "foaf:homepage", "?p")]),
         caps, "eager", tau0),
        ("types", ([("?a", A, "dbo:Athlete")], []), caps, "every2", tau0),
        ("teams", ([("?x", "dbo:team", "?t"), ("?t", A, "dbo:Team")], []), caps, "stale", tau0),
    ]
    fires = []
    broker, _ = drive_broker(tcore, d, specs, paper_cs, device, lambda i, f: fires.append(f))
    check(broker.device.type == "cuda", "the paper broker runs on the card")
    n = engine_check(tcore, d, specs, paper_cs, fires, device, oracle=True)
    log(f"small: paper example through the Broker (3 subscribers, {n} fires) equals the oracle")

    d = make_dictionary_class()()
    stream = IdSpaceStream(d, SMALL, seed + 1, BROKER_CHANGESETS)
    changesets = [stream.changeset() for _ in range(BROKER_CHANGESETS)]
    cat_caps = tcore.StepCapacities(n_removed=512, n_added=512, tau=1024, rho=1024, pulls=1024, fanout=64,
                                    dedup_candidates=4096)
    specs = broker_specs(big, big, cat_caps, stream.football_init, stream.location_init,
                         category_targets(stream)[:8])
    fires = []
    drive_broker(tcore, d, specs, changesets, device, lambda i, f: fires.append(f))
    n = engine_check(tcore, d, specs, changesets, fires, device, oracle=True)
    log(f"small: id-space stream through the Broker ({len(specs)} subscribers, {BROKER_CHANGESETS} changesets "
        f"+ flush, {n} fires) equals the oracle")


def full_caps(tcore):
    """Capacities for the full-scale replicas (powers of two, as the engine doubles them)."""
    common = dict(n_removed=1 << 17, n_added=1 << 17, fanout=8, dedup_candidates=1 << 19)
    return {
        "football": tcore.StepCapacities(tau=1 << 20, rho=1 << 18, pulls=1 << 17, **common),
        "location": tcore.StepCapacities(tau=1 << 23, rho=1 << 20, pulls=1 << 18, **common),
    }


def phase_full(tcore, device, seed, n_changesets):
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    Dict = make_dictionary_class()
    d = Dict()
    stream = IdSpaceStream(d, FULL, seed, n_changesets)
    inits = {"football": stream.football_init, "location": stream.location_init}
    changesets = [stream.changeset() for _ in range(n_changesets)]
    gen_s = time.perf_counter() - t0
    log(f"full: data in {gen_s:.1f} s: dump {stream.size - sum(a.shape[0] for _, a in changesets):,} rows, "
        f"{len(d):,} ids (id capacity {d.id_capacity:,}); τ0 football {inits['football'].shape[0]:,} rows, "
        f"location {inits['location'].shape[0]:,} rows; changesets (removed, added) "
        + ", ".join(f"({x.shape[0]:,}, {y.shape[0]:,})" for x, y in changesets))
    caps = full_caps(tcore)

    # the main path, through the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    subs, steps = drive(tcore, d, inits, changesets, caps, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"full: kernel run {wall:.2f} s (register + {n_changesets} changesets x 2 interests), "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB")
    check(launches["triple_match"] > 0 and launches["merge_probe"] > 0,
          f"a kernel of the path never launched: {launches}")
    for i, step in enumerate(steps):
        log(f"  changeset {i}: " + "; ".join(
            f"{name} {st.elapsed_s * 1e3:.1f} ms (r {st.interesting_removed:,}, a {st.interesting_added:,}, "
            f"ρ {st.potential_size:,}, τ {st.target_size:,})"
            for name, st in step["stats"].items()))
    for name, sub in subs.items():
        log(f"  {name}: caps {dataclasses.asdict(sub.caps)}, reallocations {sub.rebuilds}")
        check(int(sub.tau.n) > 0, f"{name}: τ is not empty")
    for step in steps:
        for name, stores in step["stores"].items():
            for f, st in stores.items():
                check(store_valid(st), f"{name}.{f}: a store holds sorted distinct rows then PAD")
    kernel_stores = [{n: {f: (st.spo.clone(), int(st.n)) for f, st in stores.items()}
                      for n, stores in step["stores"].items()} for step in steps]
    kernel_ms = [{n: st.elapsed_s * 1e3 for n, st in step["stats"].items()} for step in steps]
    del steps

    # the same path with the plain versions on the same card
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_probe():
        p_subs, p_steps = drive(tcore, d, inits, changesets, caps, device, matcher=ref.pattern_bitmask_ref)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    check(kernels.launch_counts() == {k: 0 for k in launches}, "the plain run launched no kernel")
    log(f"full: plain run {p_wall:.2f} s")
    for i, step in enumerate(p_steps):
        for name, stores in step["stores"].items():
            for f, st in stores.items():
                spo, n = kernel_stores[i][name][f]
                check(int(st.n) == n and torch.equal(st.spo, spo),
                      f"changeset {i} {name}.{f}: kernel run != plain run")
    log(f"full: {len(p_steps)} changesets x 2 interests x 7 stores bit-identical, kernels vs plain")
    for i, step in enumerate(p_steps):
        log(f"  changeset {i} ms kernel/plain: " + "; ".join(
            f"{n} {kernel_ms[i][n]:.1f}/{st.elapsed_s * 1e3:.1f}" for n, st in step["stats"].items()))
    del p_subs, p_steps
    distributed_check(tcore, device, d, inits["football"], changesets[0], caps["football"])
    return subs, stream, changesets, launches


# the distributed evaluator check's capacities: changeset rows a shard,
# output rows, pull rows (no capacity overflows at the full scale)
DIST_CAPS = (1 << 17, 1 << 18, 1 << 19)


def distributed_check(tcore, device, d, tau_rows, changeset, caps):
    """``make_distributed_evaluator`` over 4 logical shards of the card on
    the Football interest: both sides of a full-scale changeset against the
    Football τ0, hash-partitioned, equal to the single-device evaluator
    over the whole τ0 (the union of the shards' outputs)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import distributed as dist
    from repro_torch.core.evaluation import build_index, make_side_evaluator
    from repro_torch.core.triples import PAD

    n = 4
    plan = tcore.compile_interest(exprs(tcore)["football"], d)
    m_cap, out_cap, pull_cap = DIST_CAPS
    kw = dict(id_capacity=d.id_capacity * caps.id_headroom, fanout=caps.fanout, out_capacity=out_cap,
              pull_capacity=pull_cap)
    single = make_side_evaluator(plan, **kw)
    sharded = dist.make_distributed_evaluator(plan, dist.DeviceMesh.on_card(n), **kw)
    spo_sh, ops_sh, t_ovf = dist.prepare_target_shards(tau_rows, n, caps.tau)
    check(not t_ovf.any(), "the τ shards hold every row")
    spo_sh, ops_sh = torch.as_tensor(spo_sh, device=device), torch.as_tensor(ops_sh, device=device)
    tgt = build_index(tcore.from_numpy(tau_rows, caps.tau, device))

    def rows_of(stores) -> np.ndarray:
        arr = stores.spo.reshape(-1, 3).cpu().numpy()
        return np.unique(arr[arr[:, 0] != PAD], axis=0).reshape(-1, 3)

    for side, rows in zip(("removed", "added"), changeset):
        m_sh, m_ovf = dist.partition_rows(rows, n, key_col=0, cap=m_cap)
        check(not m_ovf.any(), "the changeset shards hold every row")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = single(tcore.from_numpy(rows, m_cap, device), tgt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        dist.reset_traffic()
        got = sharded(torch.as_tensor(m_sh, device=device), spo_sh, ops_sh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, traffic = kernels.launch_counts(), dict(dist.traffic)
        check(launches["triple_match"] > 0 and launches["merge_probe"] > 0,
              f"the distributed evaluator's kernels never launched: {launches}")
        check(not bool(want.overflow) and not bool(got.overflow.any()), f"{side}: no capacity overflows")
        sizes = []
        for f in ("interesting", "potential", "pulls"):
            w, g = rows_of(getattr(want, f)), rows_of(getattr(got, f))
            check(np.array_equal(w, g), f"distributed evaluator {side}.{f} != the single-device evaluator")
            sizes.append(f"{f} {w.shape[0]:,}")
        log(f"full: make_distributed_evaluator over {n} shards of the card, Football {side} side ({rows.shape[0]:,} "
            f"rows) = the single-device evaluator ({', '.join(sizes)}); {(t2 - t1) * 1e3:.1f} ms vs "
            f"{(t1 - t0) * 1e3:.1f} ms; launches {launches}; collectives {traffic['collectives']}, all_to_all "
            f"{traffic['all_to_all'] / 2**20:.1f} MiB")


# ---------------------------------------------------------------------------
# the multi-subscriber broker
# ---------------------------------------------------------------------------

POLICIES = ("eager", "every2", "priority", "stale")
BROKER_CHANGESETS = 4
FANOUT_SUBSCRIBERS = 256
FANOUT_CHANGESETS = 3
FANOUT_CATEGORIES = 8
ZIPF_S = 1.3  # the subscriber skew of benchmarks/broker_fanout.py


def make_policy(tcore, kind: str):
    return {
        "eager": tcore.PushPolicy(),
        "every2": tcore.PushPolicy.every(2),
        "priority": tcore.PushPolicy.priority_lane(),
        "stale": tcore.PushPolicy.max_staleness(1e9),  # drained by the closing flush
    }[kind]


def category_targets(stream) -> list:
    """τ0 of each category interest: the type, subject and label rows of the
    dump's places of that category."""
    loc, v = stream.location_init, stream.v
    subj = loc[loc[:, 1] == v["dcterms:subject"]]
    cat_of = np.full(int(loc[:, 0].max()) + 1, -1, np.int64)
    cat_of[subj[:, 0]] = subj[:, 2] - stream.cat
    keep = (((loc[:, 1] == v[A]) & (loc[:, 2] == v["dbo:Place"])) | (loc[:, 1] == v["rdfs:label"])
            | (loc[:, 1] == v["dcterms:subject"]))
    rows = loc[keep]
    cat = cat_of[rows[:, 0]]
    return [rows[cat == k] for k in range(N_CATEGORIES)]


def broker_specs(football_caps, location_caps, category_caps, football_init, location_init, category_inits):
    """(name, (bgp, ogp), caps, policy, τ0) of every subscriber: Football and
    Location x 4 and one interest per category, a quarter of each cohort per
    policy, each subscriber with its own replica."""
    specs = []
    for kind in POLICIES:
        specs.append((f"football/{kind}", FOOTBALL, football_caps, kind, football_init))
    for kind in POLICIES:
        specs.append((f"location/{kind}", LOCATION, location_caps, kind, location_init))
    for k, init in enumerate(category_inits):
        kind = POLICIES[k % len(POLICIES)]
        specs.append((f"category{k}/{kind}", category_interest(k), category_caps, kind, init))
    return specs


def drive_broker(tcore, dictionary, specs, changesets, device, on_fire, mem=None, options=None, between=None):
    """Subscribe ``specs`` and stream ``changesets`` through one ``Broker``
    (constructor ``options``; none: the default configuration), then flush;
    ``between(i, broker)``, if given, runs after changeset ``i``.
    The every(2) subscribers subscribe after the first changeset, so that
    they and the max-staleness ones both have changesets pending at the
    flush, which then fires two frontiers in one pass.
    ``on_fire(call, {name: stores})`` sees every call's fired subscribers.
    With a list ``mem``, each step appends ("call", label, bytes allocated
    before it, peak bytes allocated during it), the peak reset before each
    step."""
    import torch

    broker = tcore.Broker(dictionary, device=device, **(options or {}))
    subs = {}

    def step(label, fn):
        if mem is None:
            return fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        mem.append(("call", label, before, torch.cuda.max_memory_allocated()))
        return out

    def subscribe(spec):
        name, (bgp, ogp), caps, kind, init = spec
        expr = tcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://{name}", bgp, ogp)
        subs[name] = broker.subscribe(expr, caps, initial_target=init, policy=make_policy(tcore, kind))

    def collect(outs):
        names = {id(sub): name for name, sub in subs.items()}
        fired = {}
        for sub, out in zip(broker.subs, outs):
            if out is not None:
                fired[names[id(sub)]] = {**{f: getattr(out, f) for f in OUT_FIELDS}, "tau": sub.tau, "rho": sub.rho}
        return fired

    def subscribe_all(every2: bool):
        for spec in specs:
            if (spec[3] == "every2") == every2:
                subscribe(spec)

    step("subscribe", lambda: subscribe_all(False))
    for i, (d_np, a_np) in enumerate(changesets):
        if i == 1:
            step("subscribe every2", lambda: subscribe_all(True))
        on_fire(i, collect(step(f"changeset {i}", lambda: broker.process_changeset(d_np, a_np))))
        if between is not None:
            between(i, broker)
    on_fire(len(changesets), collect(step("flush", broker.flush)))
    return broker, subs


@contextlib.contextmanager
def plain_ops():
    """Route the broker's bank passes and probes to the plain versions on the card."""
    from repro_torch.kernels import ops, ref

    names = ("pattern_bitmask_words", "pattern_lane_bits_batched", "pattern_bitmask_words_segmented", "lane_refine")
    saved = {name: getattr(ops, name) for name in names}
    ops.pattern_bitmask_words = lambda spo, patterns, matcher=None: ref.pattern_bitmask_words_ref(spo, patterns)
    ops.pattern_lane_bits_batched = (
        lambda spo_b, patterns, lanes, active=None, matcher=None: ref.pattern_lane_bits_ref(spo_b, patterns, lanes, active))
    ops.pattern_bitmask_words_segmented = (
        lambda spo, patterns, seg, n_seg, matcher=None:
        ref.pattern_bitmask_words_segmented_ref(spo, patterns, seg, n_seg))
    ops.lane_refine = ref.lane_refine_ref
    try:
        with plain_probe():
            yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


class BankCallRecorder:
    """Records the shapes of the broker's bank kernel calls, and keeps the
    inputs the timing phase measures: the last words, segmented and refine
    passes (the flush's), the widest lanes pass of a 3-pattern (category)
    cohort and the widest lanes pass by bytes (active members' rows read,
    every member's words written). With a list ``mem``, each lanes pass
    (one a cohort pass, at its start) appends ("pass", (Ncp, n_i, nt,
    active), peak bytes allocated so far)."""

    NAMES = ("pattern_bitmask_words", "pattern_lane_bits_batched", "pattern_bitmask_words_segmented", "lane_refine")

    def __init__(self, mem=None):
        self.words_shapes, self.lanes_shapes, self.seg_shapes, self.refine_shapes = [], [], [], []
        self.words_args = self.lanes_args = self.seg_args = self.refine_args = None
        self.lanes_wide_args, self.lanes_wide_bytes = None, -1
        self.mem = mem

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops

        self.saved = {name: getattr(ops, name) for name in self.NAMES}
        words, lanes_fn = self.saved["pattern_bitmask_words"], self.saved["pattern_lane_bits_batched"]
        seg_fn, refine_fn = self.saved["pattern_bitmask_words_segmented"], self.saved["lane_refine"]

        def rec_words(spo, patterns, matcher=None):
            self.words_shapes.append(tuple(spo.shape))
            self.words_args = (spo, patterns)
            return words(spo, patterns, matcher=matcher)

        def rec_lanes(spo_b, patterns, lanes, active=None, matcher=None):
            n_active = int(active.sum()) if active is not None else spo_b.shape[0]
            self.lanes_shapes.append((*spo_b.shape[:2], lanes.shape[1], n_active))
            if self.mem is not None:
                self.mem.append(("pass", self.lanes_shapes[-1], torch.cuda.max_memory_allocated()))
            best = self.lanes_args
            if lanes.shape[1] == 3 and (best is None or spo_b.shape[0] > best[0].shape[0]):
                self.lanes_args = (spo_b, patterns, lanes, active)
            n_bytes = spo_b.shape[1] * (12 * n_active + 4 * spo_b.shape[0])
            if n_bytes > self.lanes_wide_bytes:
                self.lanes_wide_args, self.lanes_wide_bytes = (spo_b, patterns, lanes, active), n_bytes
            return lanes_fn(spo_b, patterns, lanes, active, matcher=matcher)

        def rec_seg(spo, patterns, seg, n_seg, matcher=None):
            self.seg_shapes.append((spo.shape[0], n_seg, patterns.shape[0]))
            self.seg_args = (spo, patterns, seg, n_seg)
            return seg_fn(spo, patterns, seg, n_seg, matcher=matcher)

        def rec_refine(spo, words_in, parents, residual):
            self.refine_shapes.append((tuple(spo.shape), tuple(words_in.shape), parents.shape[0]))
            self.refine_args = (spo, words_in, parents, residual)
            return refine_fn(spo, words_in, parents, residual)

        ops.pattern_bitmask_words, ops.pattern_lane_bits_batched = rec_words, rec_lanes
        ops.pattern_bitmask_words_segmented, ops.lane_refine = rec_seg, rec_refine
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, fn in self.saved.items():
            setattr(ops, name, fn)
        return False


def compose_np(pending, d2: np.ndarray, a2: np.ndarray):
    """Def 6 on host arrays: <D1, A1> then <D2, A2> is <D1 ∪ D2, (A1 \\ D2) ∪ A2>."""
    if pending is None:
        return unique_rows(d2.reshape(-1, 3)), unique_rows(a2.reshape(-1, 3))
    d1, a1 = pending
    kept = a1[~np.isin(as_records(a1), as_records(d2))]
    return unique_rows(np.concatenate([d1, d2])), unique_rows(np.concatenate([kept, a2]))


def same_rows(a, b) -> bool:
    """Two stores hold the same valid rows (capacities may differ)."""
    import torch

    n = int(a.n)
    return n == int(b.n) and torch.equal(a.spo[:n], b.spo[:n])


def engine_check(tcore, dictionary, specs, changesets, fires, device, oracle=False) -> int:
    """Every subscriber's every fire equals the port's IrapEngine (or, for
    small inputs, the pure-Python oracle) applied to the changeset composed
    on the host since its last fire; returns the fires checked."""
    from repro_torch.core.oracle import OracleEvaluator

    as_set = lambda rows: {tuple(int(x) for x in r) for r in rows}  # noqa: E731
    checked = 0
    for name, (bgp, ogp), caps, kind, init in specs:
        start = 1 if kind == "every2" else 0
        expr = tcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://{name}", bgp, ogp)
        if oracle:
            orc = OracleEvaluator(tcore.compile_interest(expr, dictionary))
            tau_set, rho_set = as_set(init), set()
        else:
            sub = tcore.IrapEngine(dictionary, device=device).register_interest(expr, caps, initial_target=init)
        pending = None
        for i, fired in enumerate(fires):
            if start <= i < len(changesets):
                pending = compose_np(pending, *changesets[i])
            got = fired.get(name)
            if got is None:
                continue
            check(pending is not None, f"{name} fired with nothing pending at call {i}")
            if oracle:
                want = orc.step(as_set(pending[0]), as_set(pending[1]), tau_set, rho_set)
                tau_set, rho_set = want["tau1"], want["rho1"]
                for f, key in [*((f, f) for f in OUT_FIELDS), ("tau", "tau1"), ("rho", "rho1")]:
                    check(tcore.to_set(got[f]) == want[key], f"{name} call {i}: {f} differs from the oracle")
            else:
                out = sub.apply(*pending)
                for f in OUT_FIELDS:
                    check(same_rows(got[f], getattr(out, f)), f"{name} call {i}: {f} differs from IrapEngine")
                check(same_rows(got["tau"], sub.tau) and same_rows(got["rho"], sub.rho),
                      f"{name} call {i}: τ/ρ differ from IrapEngine")
            pending = None
            checked += 1
        check(pending is None, f"{name}: changesets left undelivered after the flush")
    return checked


def broker_capacities(tcore):
    """Every subscriber starts at the single-changeset capacities (the
    capacity guard doubles them for composed batches)."""
    caps = full_caps(tcore)
    category = tcore.StepCapacities(n_removed=1 << 17, n_added=1 << 17, tau=1 << 16, rho=1 << 16,
                                    pulls=1 << 16, fanout=8, dedup_candidates=1 << 19)
    return caps["football"], caps["location"], category


def phase_broker(tcore, device, seed):
    """48 subscribers in three shape cohorts over the full-scale dump, through
    the default Broker (lattice and delta chain on): through the kernels (the
    main path, counted), through the plain versions on the same card
    (bit-identical), against the port's IrapEngine, and through the kernels
    with the lattice and the chain off (bit-identical, fire by fire)."""
    import torch
    from repro_torch import kernels

    t0 = time.perf_counter()
    d = make_dictionary_class()()
    stream = IdSpaceStream(d, FULL, seed, BROKER_CHANGESETS + FANOUT_CHANGESETS + 1)
    changesets = [stream.changeset() for _ in range(BROKER_CHANGESETS)]
    specs = broker_specs(*broker_capacities(tcore), stream.football_init, stream.location_init,
                         category_targets(stream))
    cat_rows = [spec[4].shape[0] for spec in specs[8:]]
    log(f"broker: data in {time.perf_counter() - t0:.1f} s: {len(specs)} subscribers; τ0 rows football "
        f"{stream.football_init.shape[0]:,}, location {stream.location_init.shape[0]:,}, category "
        f"{min(cat_rows):,}-{max(cat_rows):,}; changesets (removed, added) "
        + ", ".join(f"({x.shape[0]:,}, {y.shape[0]:,})" for x, y in changesets))

    # the main path, through the kernels
    fires, mem = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BankCallRecorder(mem) as rec:
        broker, subs = drive_broker(tcore, d, specs, changesets, device, lambda i, f: fires.append(f), mem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = max(m[3] for m in mem if m[0] == "call")
    bank = broker.bank
    n_words = broker._ensure_bank_dev().shape[0] // 32
    n_words_r = broker._bank_real_dev.shape[0] // 32
    log(f"broker: kernel run {wall:.2f} s ({len(subs)} subscribers, {BROKER_CHANGESETS} changesets + flush), "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB")
    check(len(subs) == 48, "48 subscribers")
    check(broker.subsume_interests and broker.delta_frontiers, "the default Broker has the lattice and the chain")
    # the device bank is the lattice's extended layout: real rows, then the
    # virtual rows, each padded to a power of two >= 32
    check(n_words == bank.n_words and 32 * n_words == bank.n_real_padded + bank.n_virt_padded,
          f"the device bank has {n_words} words; the bank reports {bank.n_words}")
    check(32 * n_words_r == bank.n_real_padded and broker._refine_dev is not None
          and broker._refine_dev[0].shape[0] == bank.n_virt_padded,
          "the words pass runs over the real rows and refines the virtual ones")
    check(bank.n_virtual > 0, "the category interests ride virtual lanes")
    for name in ("triple_match_words", "triple_match_lanes", "merge_probe", "triple_match_words_segmented",
                 "lane_refine"):
        check(launches[name] > 0, f"{name} never launched on the broker's path: {launches}")
    log(f"  bank: {bank.n_real} real lanes ({bank.bank.n_lanes} allocated) padded to {bank.n_real_padded} rows "
        f"(W {n_words_r}), {bank.n_virtual} virtual lanes padded to {bank.n_virt_padded} rows (W "
        f"{n_words - n_words_r}), of {sum(s.plan.n_total for s in subs.values())} patterns; the device bank "
        f"{32 * n_words} rows, W = {n_words}")
    log(f"  words passes (rows): {[s[0] for s in rec.words_shapes]}; segmented passes (rows, n_seg, bank rows): "
        f"{rec.seg_shapes}; refine passes (rows, words, Vp): {rec.refine_shapes}; lanes passes "
        f"(Ncp, n_i, nt, active): {sorted(set(rec.lanes_shapes))}")
    for i, st in enumerate(broker.stats):
        label = f"changeset {i}" if i < BROKER_CHANGESETS else "flush"
        per_pass = st.elapsed_s / st.n_cohort_passes * 1e3 if st.n_cohort_passes else 0.0
        log(f"  {label}: {st.elapsed_s * 1e3:.1f} ms, {st.n_evaluated} fired, {st.n_cohort_passes} cohort passes "
            f"({per_pass:.1f} ms a pass), builds {st.rejit_s * 1e3:.1f} ms, rows matched {st.rows_matched:,} "
            f"(distinct {st.rows_distinct:,}), slots {st.distinct_interests} for {st.fanout_copies} deliveries, "
            f"r {st.interesting_removed:,}, a {st.interesting_added:,}")
    flush = broker.stats[-1]
    check(flush.n_evaluated == 24 and flush.rows_matched == flush.rows_distinct and rec.seg_shapes
          and rec.seg_shapes[-1][1] == 2,
          "the flush fired two frontiers through the delta chain (rows matched == rows distinct)")
    doublings = {}
    for name, sub in subs.items():
        group = name.split("/")[0].rstrip("0123456789") + "/" + name.split("/")[1]
        spec_caps = next(spec[2] for spec in specs if spec[0] == name)
        doublings[group] = doublings.get(group, 0) + (sub.caps.n_removed // spec_caps.n_removed).bit_length() - 1
    log("  device memory by call (GiB allocated before / peak during, peak reset at each call; within a "
        "call, the peak so far at the start of each cohort pass (Ncp, n_i, nt, active)):")
    line = []
    for m in mem:
        if m[0] == "pass":
            line.append(f"{m[1]} {m[2] / 2**30:.2f}")
        else:
            log(f"    {m[1]}: {m[2] / 2**30:.2f}/{m[3] / 2**30:.2f}" + (f"; passes {', '.join(line)}" if line else ""))
            line = []
    log(f"  step builds {broker.rejit_count} (cohort {sum(broker.cohort_compiles.values())}, words "
        f"{broker.words_compiles}); capacity doublings by subscriber group {doublings}; batch doublings "
        f"{broker.batch_grows}, decays {broker.batch_shrinks}")
    n_stores = 0
    for fired in fires:
        for name, stores in fired.items():
            for f, st in stores.items():
                check(store_valid(st), f"broker {name}.{f}: a store holds sorted distinct rows then PAD")
                n_stores += 1
    log(f"broker: {n_stores} stores sorted, distinct and PAD-tailed")

    # the same path with the plain versions on the same card
    log(f"broker: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the plain run "
        "(the kernel run's replicas and kept fires)")
    kernels.reset_launch_counts()
    compared = [0]

    def compare(i, fired):
        check(sorted(fired) == sorted(fires[i]), f"call {i}: the plain run fired other subscribers")
        for name, stores in fired.items():
            for f, st in stores.items():
                want = fires[i][name][f]
                check(int(st.n) == int(want.n) and torch.equal(st.spo, want.spo),
                      f"call {i} {name}.{f}: kernel run != plain run")
                compared[0] += 1

    t0 = time.perf_counter()
    with plain_ops():
        p_broker, _ = drive_broker(tcore, d, specs, changesets, device, compare)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    check(all(n == 0 for n in kernels.launch_counts().values()), "the plain run launched no kernel")
    log(f"broker: plain run {p_wall:.2f} s; {compared[0]} stores bit-identical, kernels vs plain; ms per call "
        "kernel/plain: " + ", ".join(f"{a.elapsed_s * 1e3:.1f}/{b.elapsed_s * 1e3:.1f}"
                                     for a, b in zip(broker.stats, p_broker.stats)))
    del p_broker

    # the same subscribers through the kernels with the lattice and the delta
    # chain off: the stacked path, fire by fire equal to the default run
    kernels.reset_launch_counts()
    compared[0] = 0
    t0 = time.perf_counter()
    off_broker, _ = drive_broker(tcore, d, specs, changesets, device, compare,
                                 options=dict(subsume_interests=False, delta_frontiers=False))
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    off_launches = kernels.launch_counts()
    check(off_launches["triple_match_words_segmented"] == 0 and off_launches["lane_refine"] == 0
          and off_launches["triple_match_words"] > 0, f"the lattice-off run took the stacked path: {off_launches}")
    off_flush = off_broker.stats[-1]
    log(f"broker: lattice and chain off {off_wall:.2f} s, launches {off_launches}; {compared[0]} stores "
        f"bit-identical to the default run; flush rows matched {off_flush.rows_matched:,} (distinct "
        f"{off_flush.rows_distinct:,}) vs {flush.rows_matched:,}; device bank {off_broker._ensure_bank_dev().shape[0]} "
        "rows; ms per call default/off: " + ", ".join(
            f"{a.elapsed_s * 1e3:.1f}/{b.elapsed_s * 1e3:.1f}" for a, b in zip(broker.stats, off_broker.stats)))
    del off_broker

    # every fire against the port's single-interest engine
    t0 = time.perf_counter()
    n_checked = engine_check(tcore, d, specs, changesets, fires, device)
    log(f"broker: {n_checked} fires equal the port's IrapEngine on the host-composed changesets "
        f"({time.perf_counter() - t0:.1f} s)")
    del fires
    return broker, stream, rec, launches


DURABLE_KERNELS = ("merge_probe", "triple_match_words", "triple_match_lanes", "triple_match_words_segmented",
                   "lane_refine")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_durable(tcore, device, seed, card):
    """The broker phase's 48 subscribers through a journaled default Broker
    with a delivery channel, crashed and recovered at three boundaries on
    the card (module docstring, phase 8)."""
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.testing import (CapturingJournal, FakeClock, ScriptedTransport, assert_state_equal,
                                     broker_state, crash_at_record)

    class TimedAppends(tcore.ChangesetJournal):
        """Times each frame's write and fsync by kind, with its bytes on disk."""

        def append(self, kind, meta=None, arrays=None, seq=None):
            size0 = dir_bytes(self.dir)
            t0 = time.perf_counter()
            out = super().append(kind, meta=meta, arrays=arrays, seq=seq)
            dt = time.perf_counter() - t0
            n, secs, nbytes = self.times.get(kind, (0, 0.0, 0))
            self.times[kind] = (n + 1, secs + dt, nbytes + dir_bytes(self.dir) - size0)
            return out

    class Journal(CapturingJournal, TimedAppends):
        """Captures the broker's state before the chosen ingest records (by
        ordinal); the capture is not in the timed append."""

        def __init__(self, *args, capture_before=(), **kw):
            self.capture_before = set(capture_before)
            self.captures, self.times, self.n_ingests, self.broker = {}, {}, 0, None
            super().__init__(*args, on_append=self._capture, **kw)

        def _capture(self, seq, kind):
            if kind == "ingest":
                if self.n_ingests in self.capture_before:
                    self.captures[self.n_ingests] = (seq, broker_state(self.broker))
                self.n_ingests += 1

    def state_check(want, got, what):
        try:
            assert_state_equal(want, got)
        except AssertionError as e:
            raise SmokeFailure(f"{what}: {str(e)[:400]}") from None

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = make_dictionary_class()()
    stream = IdSpaceStream(d, FULL, seed, BROKER_CHANGESETS + 1)
    changesets = [stream.changeset() for _ in range(BROKER_CHANGESETS + 1)]
    carry_on = changesets.pop()
    specs = broker_specs(*broker_capacities(tcore), stream.football_init, stream.location_init,
                         category_targets(stream))
    del stream
    log(f"durable: data in {time.perf_counter() - t0:.1f} s, the broker phase's dump and {len(specs)} subscribers")

    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="durable-", dir=REPO / "build"))
    try:
        clk = FakeClock()
        transport = ScriptedTransport(scripts={0: ["fail"]}, clock=clk)  # jid 0: football/eager
        channel = tcore.DeliveryChannel(transport, max_attempts=1, base_backoff_s=1.0, jitter=0.0, clock=clk,
                                        sleep=clk.sleep)
        # the state before the second and the fourth ingest: crashes before
        # the snapshot and after it
        journal = Journal(tmp / "wal", fsync=True, capture_before=(1, 3))
        store = CheckpointStore(tmp / "ckpt")
        snap = {}

        def between(i, broker):
            journal.broker = broker
            if i == 1:
                # the journal as a crash before the snapshot finds it
                journal.sync()
                shutil.copytree(tmp / "wal", tmp / "wal-before-snapshot")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                snap["seq"] = broker.snapshot(store)
                snap["s"] = time.perf_counter() - t1
                snap["bytes"] = dir_bytes(tmp / "ckpt")
                snap["removed"] = broker.compact_journal()
            clk.advance(2.0)  # the failed delivery's backoff elapses

        t0 = time.perf_counter()
        broker, subs = drive_broker(tcore, d, specs, changesets, device, lambda i, f: None,
                                    options=dict(journal=journal, channel=channel),
                                    between=between)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        journal.broker = broker
        final = broker_state(broker)
        journal.sync()
        n = journal.last_seq
        failed = subs["football/eager"]
        check(len(subs) == 48 and failed.jid == 0, "48 subscribers, football/eager first")
        check(channel.stats.failures == 1 and channel.failures(failed) == 0 and failed.since > broker._last_cid
              and transport.log.count((0, "fail")) == 1 and transport.log.count((0, "ok")) >= 2,
              f"one failed delivery that backed off and caught up: {channel.stats}, {transport.log[:6]}")
        check(snap["removed"] > 0, "the compaction dropped segments")
        check(sorted(journal.captures) == [1, 3] and journal.captures[1][0] <= snap["seq"] < journal.captures[3][0],
              f"captures before and after the snapshot at seq {snap['seq']}: {sorted(journal.captures)}")
        ingests = journal.times["ingest"]
        log(f"durable [{card}]: journaled run {wall:.2f} s, {n} records (fsync on each); journal "
            f"{dir_bytes(tmp / 'wal-before-snapshot') / 2**20:.1f} MiB before the compaction, "
            f"{dir_bytes(tmp / 'wal') / 2**20:.1f} MiB after the flush ({snap['removed']} segments dropped); "
            f"ingest records: {ingests[0]}, {ingests[2] / ingests[0] / 2**20:.2f} MiB and "
            f"{ingests[1] / ingests[0] * 1e3:.1f} ms an append; by kind (records, s, MiB): "
            + ", ".join(f"{k} ({c}, {t:.3f}, {b / 2**20:.1f})" for k, (c, t, b) in sorted(journal.times.items())))
        log(f"durable [{card}]: snapshot at seq {snap['seq']} in {snap['s']:.2f} s, "
            f"{snap['bytes'] / 2**20:.1f} MiB; delivery {channel.stats}")

        first = int(sorted((tmp / "wal").glob("wal_*.seg"))[0].name.split("_")[1].split(".")[0])
        points = [("before the snapshot", tmp / "wal-before-snapshot", 1, journal.captures[1][0] - 1),
                  ("after the snapshot", tmp / "wal", first, journal.captures[3][0] - 1),
                  ("at the last record", tmp / "wal", first, n)]
        wants = {n: final, **{seq - 1: {**st, "seq": seq - 1} for seq, st in journal.captures.values()}}
        totals = dict.fromkeys(DURABLE_KERNELS, 0)
        recovered = None
        for label, src, first_seq, k in points:
            del recovered
            gc.collect()
            torch.cuda.empty_cache()
            dst = tmp / f"crash{k}"
            check(crash_at_record(src, dst, k - first_seq + 1) == k - first_seq + 1, f"crash at {k}")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            recovered = tcore.Broker.recover(tcore.ChangesetJournal(dst, fsync=True), store, dictionary=d,
                                             device=device)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = kernels.launch_counts()
            for name in DURABLE_KERNELS:
                totals[name] += launches[name]
            state_check(wants[k], broker_state(recovered), f"recovery {label} (seq {k})")
            log(f"durable [{card}]: recovery {label} (crash at seq {k} of {n}; snapshot "
                f"{'used' if snap['seq'] <= k else 'not yet taken'}) in {secs:.2f} s, bit-identical to the "
                f"capture; launches {launches}")
        log(f"durable: the three recoveries' launches {totals}")
        for name in DURABLE_KERNELS:
            check(totals[name] > 0, f"{name} never launched in the recoveries: {totals}")

        # the last recovery and the uninterrupted broker go on alike
        got = recovered.process_changeset(*carry_on)
        want = broker.process_changeset(*carry_on)
        check(len(got) == len(want) == 48 and [s.jid for s in recovered.subs] == [s.jid for s in broker.subs],
              "the recovered broker holds the same subscribers in the same order")
        for g, w, s in zip(got, want, broker.subs):
            check((g is None) == (w is None), f"subscriber {s.jid}: fired in one broker only")
            if g is not None:
                for f in OUT_FIELDS:
                    a, b = getattr(g, f), getattr(w, f)
                    check(int(a.n) == int(b.n) and torch.equal(a.spo, b.spo), f"subscriber {s.jid}.{f} differs")
        state_check(broker_state(broker), broker_state(recovered), "the carried-on recovery")
        torch.cuda.synchronize()
        log(f"durable [{card}]: the recovered broker equals the uninterrupted one after one more changeset "
            f"({sum(g is not None for g in got)} fired); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB (earlier phases held {held / 2**30:.2f} GiB at its start; the uninterrupted and one recovered "
            "broker live at once)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SHARDED_KERNELS = ("merge_probe", "triple_match_words", "triple_match_lanes", "triple_match_words_segmented")
N_SHARDS = 4


def phase_sharded(tcore, device, seed, card):
    """The broker phase's 48 subscribers over a mesh of 4 logical shards of
    the card, default Broker, in lockstep with an unsharded Broker: sharded
    (``shard_cohorts=True``) and placed by load; every fire of both equals
    the unsharded fire bit for bit (module docstring, phase 9). The
    unsharded and placed brokers take the broker phase's capacities; the
    sharded one the same without candidate dedup, which it refuses (a
    shard sees its own pools only). Dedup changes no output, only how large
    the pools grow; a store whose capacity grew differently (an overflow
    that only one of the settings met) is compared on its rows."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import distributed as dist
    from repro_torch.core.triples import PAD

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = make_dictionary_class()()
    stream = IdSpaceStream(d, FULL, seed, BROKER_CHANGESETS)
    changesets = [stream.changeset() for _ in range(BROKER_CHANGESETS)]
    specs = broker_specs(*broker_capacities(tcore), stream.football_init, stream.location_init,
                         category_targets(stream))
    del stream
    log(f"sharded: data in {time.perf_counter() - t0:.1f} s, the broker phase's dump, {len(specs)} subscribers and "
        "capacities (the sharded broker without candidate dedup)")

    mesh = dist.DeviceMesh.on_card(N_SHARDS)
    options = {"unsharded": {}, "sharded": dict(mesh=mesh, shard_cohorts=True),
               "placed": dict(mesh=mesh, placement=dist.CohortPlacement(mode="load_balanced"))}
    brokers = {name: tcore.Broker(d, device=device, **opts) for name, opts in options.items()}
    subs = {name: {} for name in brokers}
    launches = {name: dict.fromkeys(kernels.launch_counts(), 0) for name in brokers}
    fire_ms = {name: [] for name in brokers}
    exchange = []
    n_compared = [0]
    resized = {name: 0 for name in brokers}
    peaks = [0]

    def collect(name, outs):
        names = {id(sub): n for n, sub in subs[name].items()}
        return {names[id(sub)]: {**{f: getattr(out, f) for f in OUT_FIELDS}, "tau": sub.tau, "rho": sub.rho}
                for sub, out in zip(brokers[name].subs, outs) if out is not None}

    def step(label, fn):
        """``fn(broker, subs)`` on each broker in turn, its kernels counted,
        its time and peak memory taken; the sharded and placed fires are
        held against the unsharded one as soon as they exist."""
        want = None
        for name, broker in brokers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            dist.reset_traffic()
            t1 = time.perf_counter()
            outs = fn(broker, subs[name])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            peaks[0] = max(peaks[0], torch.cuda.max_memory_allocated())
            for k, v in kernels.launch_counts().items():
                launches[name][k] += v
            if outs is None:
                continue
            fire_ms[name].append((label, ms, torch.cuda.max_memory_allocated()))
            got = collect(name, outs)
            del outs
            if name == "sharded":
                exchange.append((label, dict(dist.traffic)))
            if want is None:
                want = got
                continue
            check(sorted(got) == sorted(want), f"{label}: the {name} broker fired others")
            for sub_name, stores in got.items():
                for f, st in stores.items():
                    w = want[sub_name][f]
                    n = int(w.n)
                    if st.spo.shape != w.spo.shape:
                        resized[name] += 1
                    check(int(st.n) == n and torch.equal(st.spo[:n], w.spo[:n]) and bool((st.spo[n:] == PAD).all()),
                          f"{label} {sub_name}.{f}: the {name} broker != the unsharded one")
                    n_compared[0] += 1
            del got

    def subscribe(every2: bool):
        def fn(broker, subs_of):
            for name, (bgp, ogp), caps_of, kind, init in specs:
                if (kind == "every2") == every2:
                    expr = tcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://{name}", bgp, ogp)
                    if broker.shard_cohorts:
                        caps_of = dataclasses.replace(caps_of, dedup_candidates=0)
                    subs_of[name] = broker.subscribe(expr, caps_of, initial_target=init, policy=make_policy(tcore, kind))
        return fn

    t0 = time.perf_counter()
    step("subscribe", subscribe(False))
    for i, cs in enumerate(changesets):
        if i == 1:
            step("subscribe every2", subscribe(True))
        step(f"changeset {i}", lambda broker, _, cs=cs: broker.process_changeset(*cs))
    step("flush", lambda broker, _: broker.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = peaks[0]
    sh, pl = brokers["sharded"], brokers["placed"]
    log(f"sharded [{card}]: {len(fire_ms['sharded'])} calls x 3 brokers in {wall:.1f} s; {n_compared[0]} stores of "
        f"the sharded and placed brokers bit-identical to the unsharded broker's, fire by fire (of another capacity: "
        f"sharded {resized['sharded']}, placed {resized['placed']})")
    for name in brokers:
        log(f"  {name}: ms per call (peak GiB) " + ", ".join(f"{label} {ms:.1f} ({pk / 2**30:.2f})"
                                                          for label, ms, pk in fire_ms[name])
            + f"; launches {launches[name]}; cohort passes by device {dict(sorted(brokers[name].device_passes.items()))}")
    log("  sharded probe exchange (all_to_all MiB, all_gather MiB, or_reduce MiB, collectives) per call: " + ", ".join(
        f"{label} ({t['all_to_all'] / 2**20:.1f}, {t['all_gather'] / 2**20:.1f}, {t['or_reduce'] / 2**20:.1f}, "
        f"{t['collectives']:,})" for label, t in exchange))
    log(f"sharded [{card}]: τ partitions cached {len(sh._tau_parts_cache)}, "
        f"{sum(p[0].numel() + p[1].numel() for p in sh._tau_parts_cache.values()) * 4 / 2**30:.2f} GiB; peak device "
        f"memory {peak / 2**30:.2f} GiB (earlier phases held {held / 2**30:.2f} GiB at its start; three brokers "
        "live at once, the unsharded broker's fires of one call kept)")
    check(len(subs["sharded"]) == 48 and n_compared[0] > 0, "48 subscribers, fires compared")
    check(resized["placed"] == 0, "the placed broker's stores have the unsharded broker's capacities")
    for name in SHARDED_KERNELS:
        check(launches["sharded"][name] > 0, f"{name} never launched in the sharded run: {launches['sharded']}")
    check(launches["sharded"]["lane_refine"] == 0 and sh.words_compiles == 0,
          "the sharded step matches virtual lanes as bank rows, block-split: no shared words pass, no lane refine")
    check(launches["placed"]["lane_refine"] > 0, f"lane_refine never launched in the placed run: {launches['placed']}")
    check(sorted(sh.device_passes) == list(range(N_SHARDS)) and len(set(sh.device_passes.values())) == 1,
          f"every sharded pass spans the mesh: {sh.device_passes}")
    check(len(pl.device_passes) > 1, f"the placed cohorts spread over the mesh: {pl.device_passes}")


# ---------------------------------------------------------------------------
# phase 10: the model plane's serving path
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_SEQ, SERVE_DECODE = 4, 32, 16  # replica prompts, greedy steps
XATTN_BATCH, XATTN_SEQ, XATTN_DECODE = 2, 16, 8  # whisper and the vision model
SYNC_BATCH, SYNC_SEQ, SYNC_SHARE = 2, 16, 0.25  # (layer, expert) rows perturbed
RING_PREFILL = 1100  # > gemma3's window of 1,024: the ring has wrapped
RING_TOL = 1e-4  # float32, TF32 off: prefill(1,101) vs prefill(1,100) + a decode step
CARD_CPU_TOL = 1e-4  # float32, TF32 off: the card's logits vs the CPU's, same weights
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")  # the state-space families, at full width
SSM_FORCED = 1024  # falcon-mamba: 2 Mamba-1 chunks of 512; zamba2: 4 SSD chunks of 256
# float32, TF32 off: prefill(1,024) (chunked) vs prefill(1,023) (one chunk: 1,023 is no multiple of
# either chunk) + a decode step. The sides sum the same float32 terms in different orders in each of
# 64 or 81 layers; in float64 they agree to 1e-13 (a float64 copy of the port at smoke width,
# experiments/torch_ssm_gaps.py), so the gap is float32 rounding. falcon-mamba's Hillis-Steele scan multiplies decays: ten times RING_TOL.
# zamba2's SSD forms its decays as exp(cs_i - cs_j) from cumulative sums of dt·A that reach ~-800
# over the 1,023-token chunk, where a float32 step is 6e-5: the one-chunk side's decays carry that
# error, in the reference as in the port (2.1e-5 and 1.9e-5 at smoke width, 1,024 tokens, CPU);
# measured 3.6e-3 at full width (H100), held to about three times that
SSM_FORCED_TOL = {"falcon-mamba-7b": 1e-3, "zamba2-7b": 1e-2}
VISION_CUT = 5  # layers of llama-3.2-vision-90b kept: one group, 4 self + 1 cross
GATE = 0.5  # the vision model's cross gates, zero at init


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 products and convolutions on the card (no TF32), restored after."""
    import torch

    old, old_conv = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cudnn.allow_tf32 = old_conv


def fresh_model(cfg, device, seed):
    """A model of ``cfg`` on ``device``, weights drawn from a seeded generator."""
    import torch
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return build_model(cfg, device).init(torch.Generator(device).manual_seed(seed))


def n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def serve_timed(model, batch, n_decode: int):
    """``launch/serve``'s greedy loop, after one untimed warm-up call."""
    from repro_torch.launch import serve

    serve.greedy(model, batch, 2)
    return serve.greedy(model, batch, n_decode + 1)


def serve_line(name, out, n_decode, card) -> str:
    import torch

    return (f"models [{card}]: {name}: prefill {out['prefill_ms']:.2f} ms, decode {out['decode_ms'] / n_decode:.2f} ms "
            f"a token ({n_decode} steps), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def check_logits(logits, rows: int, cfg, what: str) -> None:
    import torch

    check(tuple(logits.shape) == (rows, cfg.padded_vocab), f"{what}: logits of shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()), f"{what}: logits are finite")


def models_serving(tcore, device, seed, card, football_rows, dictionary):
    """internlm2-1.8b at full width serves prompts drawn from phase 4's
    Football replica: verbalized, batched by ``ReplicaTokenPipeline``, then
    prefill and greedy decode through ``launch/serve``."""
    from repro_torch.configs import get_config
    from repro_torch.core.interest import next_pow2
    from repro_torch.data import ReplicaTokenPipeline, Verbalizer

    cfg = get_config("internlm2-1.8b")
    replica = tcore.from_numpy(football_rows, next_pow2(football_rows.shape[0]), "cpu")
    verb = Verbalizer(vocab=cfg.vocab, dictionary=dictionary)
    pipe = ReplicaTokenPipeline(verb, batch_size=SERVE_BATCH, seq_len=SERVE_SEQ, seed=seed)
    pipe.refresh(replica)
    batch = next(pipe)
    check(batch["tokens"].shape == (SERVE_BATCH, SERVE_SEQ) and 0 <= batch["tokens"].min()
          and batch["tokens"].max() < cfg.vocab, "replica prompts of the batch's shape inside the vocabulary")
    model = fresh_model(cfg, device, seed)
    out = serve_timed(model, {"tokens": batch["tokens"]}, SERVE_DECODE)
    check(out["tokens"].shape == (SERVE_BATCH, SERVE_DECODE + 1), "a greedy token per step and sequence")
    check_logits(out["logits"], SERVE_BATCH, cfg, "internlm2 serving")
    log(f"models: replica → prompts: Football τ {football_rows.shape[0]:,} rows verbalized, "
        f"batch {SERVE_BATCH} x {SERVE_SEQ}; internlm2-1.8b at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab:,}; {n_params(model) / 1e9:.3f}B float32 parameters, bfloat16 compute)")
    log(serve_line("internlm2-1.8b", out, SERVE_DECODE, card))
    log(f"  generated ids (first sequence): {out['tokens'][0].tolist()}")
    cache = model.prefill({"tokens": batch["tokens"], "max_seq": SERVE_SEQ + 1})[1]
    tok = out["tokens"][:, 0]
    profile_call("internlm2-1.8b decode step", lambda: model.decode_step(cache, tok, SERVE_SEQ))


def models_param_sync(device, seed, card):
    """granite-moe-3b-a800m's expert banks published as row changesets to a
    mirror replica and a replica hosting the even experts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import param_sync as ps

    cfg = get_config("granite-moe-3b-a800m")
    model = fresh_model(cfg, device, seed)
    banks = {f"layers.{j}.mlp.{w}": getattr(layer.mlp, w)
             for j, layer in enumerate(model.layers) for w in ("wg", "wi", "wo")}
    even = torch.arange(0, cfg.n_experts, 2, device=device)
    mirror = ps.ParamReplica({n: b.clone() for n, b in banks.items()}, {n: None for n in banks})
    half = ps.ParamReplica({n: b.clone() for n, b in banks.items()}, {n: even for n in banks})
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed)
    picked = rng.random((cfg.n_layers, cfg.n_experts)) < SYNC_SHARE  # (layer, expert) rows to perturb
    old_rows, changesets = {}, []
    # the mirror's receive is an apply (its filter keeps every row); the
    # half replica's is a filter and an apply; the filter is also timed alone
    ms = {"diff": 0.0, "filter": 0.0, "mirror receive (apply)": 0.0, "half receive (filter + apply)": 0.0}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[key] += (time.perf_counter() - t0) * 1e3
        return out

    for name, bank in banks.items():  # the publisher: perturb, diff, publish
        rows = torch.as_tensor(np.flatnonzero(picked[int(name.split(".")[1])]), device=device)
        new = bank.clone()
        new[rows] += 0.01 * torch.randn(new[rows].shape, generator=gen, device=device)
        old_rows[name] = (rows, bank[rows].clone())
        cs = timed("diff", lambda: ps.diff_bank(name, bank, new))
        check(torch.equal(cs.rows.long(), rows), f"{name}: the diff publishes the perturbed rows")
        bank.copy_(new)
        changesets.append(cs)
        del new
    for cs in changesets:
        timed("filter", lambda: ps.filter_changeset(cs, even))
        timed("mirror receive (apply)", lambda: mirror.receive(cs))
        timed("half receive (filter + apply)", lambda: half.receive(cs))
    subscribed = torch.zeros(cfg.n_experts, dtype=torch.bool, device=device)
    subscribed[even] = True
    for name, bank in banks.items():
        check(torch.equal(mirror.banks[name], bank), f"{name}: the mirror equals the source")
        rows, old = old_rows[name]
        want = bank.clone()
        keep_old = ~subscribed[rows]
        want[rows[keep_old]] = old[keep_old]
        check(torch.equal(half.banks[name], want),
              f"{name}: the half replica holds the source's even experts and its own old odd ones")
    check(0.3 < half.savings < 0.7 and mirror.savings == 0.0, f"savings {half.savings}, {mirror.savings}")

    tokens = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (SYNC_BATCH, SYNC_SEQ)).astype(np.int32)

    def logits_now():
        first, cache = model.prefill({"tokens": tokens, "max_seq": SYNC_SEQ + 1})
        step, _ = model.decode_step(cache, first[:, :cfg.vocab].argmax(-1), SYNC_SEQ)
        return first, step

    src = logits_now()
    for name, bank in banks.items():  # serve from the mirror's banks
        bank.data = mirror.banks[name]
    got = logits_now()
    check(all(torch.equal(a, b) for a, b in zip(src, got)),
          "the mirror replica's prefill and decode logits equal the source model's bit for bit")
    check_logits(got[0], SYNC_BATCH, cfg, "granite mirror")
    offered = sum(cs.nbytes for cs in changesets)
    log(f"models [{card}]: granite-moe-3b-a800m at full width ({cfg.n_layers} layers x {cfg.n_experts} experts, "
        f"top {cfg.top_k}; {n_params(model) / 1e9:.3f}B parameters): {len(changesets)} bank changesets, "
        f"{int(picked.sum())} of {picked.size} (layer, expert) rows perturbed; offered {offered / 2**20:.1f} MiB, "
        f"received: mirror {mirror.bytes_received / 2**20:.1f} MiB, even-experts replica "
        f"{half.bytes_received / 2**20:.1f} MiB (savings {half.savings:.4f}); ms over all banks: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        + f"; mirror logits bit-identical to the source's; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def models_ring(device, seed, card):
    """gemma3-4b (local/global, window 1,024) in float32: a decode step at
    position 1,100 over a wrapped ring against a prefill over 1,101 tokens."""
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-4b"), dtype="float32")
    check(RING_PREFILL > cfg.window, "the ring wraps")
    tokens = np.random.default_rng(seed + 2).integers(0, cfg.vocab, (1, RING_PREFILL + 1)).astype(np.int32)
    with float32_matmuls():
        model = fresh_model(cfg, device, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill({"tokens": tokens[:, :RING_PREFILL], "max_seq": RING_PREFILL + 1})
        step, _ = model.decode_step(cache, tokens[:, RING_PREFILL], RING_PREFILL)
        full, _ = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_logits(step, 1, cfg, "gemma3 decode")
    err = float((step[:, :cfg.vocab] - full[:, :cfg.vocab]).abs().max())
    scale = float(full[:, :cfg.vocab].abs().max())
    log(f"models [{card}]: gemma3-4b at full width, float32, TF32 off ({cfg.n_layers} layers, window {cfg.window}): "
        f"decode at position {RING_PREFILL} over the wrapped ring vs a prefill over {RING_PREFILL + 1} tokens: "
        f"max |Δ logit| {err:.3e} (tolerance {RING_TOL:g}; max |logit| {scale:.2f}); {wall:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(err <= RING_TOL, f"gemma3 ring teacher forcing: {err} > {RING_TOL}")


def models_encdec(device, seed, card):
    """whisper-medium (enc_seq 1,500): prefill and greedy decode."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium")
    rng = np.random.default_rng(seed + 3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (XATTN_BATCH, XATTN_SEQ)).astype(np.int32),
             "enc_embed": rng.normal(size=(XATTN_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    model = fresh_model(cfg, device, seed)
    out = serve_timed(model, batch, XATTN_DECODE)
    check_logits(out["logits"], XATTN_BATCH, cfg, "whisper")
    log(serve_line(f"whisper-medium at full width ({cfg.n_enc_layers} + {cfg.n_layers} layers, enc_seq "
                   f"{cfg.enc_seq}, batch {XATTN_BATCH} x {XATTN_SEQ}; {n_params(model) / 1e9:.3f}B parameters)",
                   out, XATTN_DECODE, card))


def models_vision(device, seed, card):
    """llama-3.2-vision-90b at full width, cut to one group, gates nonzero."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import CrossBlock

    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=VISION_CUT)
    rng = np.random.default_rng(seed + 4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (XATTN_BATCH, XATTN_SEQ)).astype(np.int32),
             "img_embed": rng.normal(size=(XATTN_BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}
    model = fresh_model(cfg, device, seed)
    gates = [m.gate for m in model.modules() if isinstance(m, CrossBlock)]
    check(len(gates) == 1, "one cross block")
    for g in gates:
        g.fill_(GATE)
    out = serve_timed(model, batch, XATTN_DECODE)
    check_logits(out["logits"], XATTN_BATCH, cfg, "vision")
    log(serve_line(f"llama-3.2-vision-90b at full width cut to {cfg.n_layers} of {full.n_layers} layers (one group: "
                   f"{cfg.cross_attn_every - 1} self + 1 cross, gate tanh({GATE})), {cfg.n_img_tokens} image tokens, "
                   f"batch {XATTN_BATCH} x "
                   f"{XATTN_SEQ}; {n_params(model) / 1e9:.3f}B parameters", out, XATTN_DECODE, card))


def models_card_vs_cpu(device, seed, card, arch="internlm2-1.8b", n_layers=2):
    """``arch`` at full width cut to ``n_layers`` layers, float32: one
    prefill and one decode step on the card and on the CPU with the same
    weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab, (SYNC_BATCH, SYNC_SEQ)).astype(np.int32)
    batch = {"tokens": tokens, "max_seq": SYNC_SEQ + 1}
    with float32_matmuls():
        on_card = fresh_model(cfg, device, seed)
        on_cpu = build_model(cfg, "cpu")
        on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
        got = {}
        for where, model in (("card", on_card), ("cpu", on_cpu)):
            first, cache = model.prefill(batch)
            step, _ = model.decode_step(cache, torch.as_tensor(tokens[:, -1]), SYNC_SEQ)
            got[where] = (first.cpu(), step.cpu())
    errs = [float((a[:, :cfg.vocab] - b[:, :cfg.vocab]).abs().max()) for a, b in zip(got["card"], got["cpu"])]
    for logits in got["card"]:
        check_logits(logits, SYNC_BATCH, cfg, f"{arch} card vs CPU")
    log(f"models [{card}]: card vs CPU, {arch} at full width cut to {cfg.n_layers} layers, float32, TF32 "
        f"off: max |Δ logit| prefill {errs[0]:.3e}, decode {errs[1]:.3e} (tolerance {CARD_CPU_TOL:g})")
    check(max(errs) <= CARD_CPU_TOL, f"{arch} card vs CPU: {errs} > {CARD_CPU_TOL}")


def models_state_space(device, seed, card, arch):
    """falcon-mamba-7b (Mamba-1) or zamba2-7b (Mamba-2 with its shared
    attention block) at full width: served through ``launch/serve`` at
    the phase's batch, then, in float32 with TF32 off, a 1,024-token
    prefill (several chunks) against a 1,023-token prefill (one chunk) and
    a decode step."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    tokens = np.random.default_rng(seed + 6).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_SEQ)).astype(np.int32)
    model = fresh_model(cfg, device, seed)
    out = serve_timed(model, {"tokens": tokens}, SERVE_DECODE)
    check(out["tokens"].shape == (SERVE_BATCH, SERVE_DECODE + 1), f"{arch}: a greedy token per step and sequence")
    check_logits(out["logits"], SERVE_BATCH, cfg, f"{arch} serving")
    shape = (f"{cfg.n_layers // cfg.shared_attn_every} groups of {cfg.shared_attn_every} Mamba-2 layers and one "
             f"shared attention block, a tail of {cfg.n_layers % cfg.shared_attn_every}"
             if cfg.family == "hybrid" else f"{cfg.n_layers} Mamba-1 layers")
    log(serve_line(f"{arch} at full width ({shape}; d_model {cfg.d_model}, d_inner {cfg.d_inner}, d_state "
                   f"{cfg.d_state}; {n_params(model) / 1e9:.3f}B float32 parameters, bfloat16 compute; batch "
                   f"{SERVE_BATCH} x {SERVE_SEQ})", out, SERVE_DECODE, card))
    del model, out
    cfg = dataclasses.replace(cfg, dtype="float32")
    chunk = cfg.scan_chunk if cfg.ssm_kind == "mamba1" else cfg.ssm_chunk
    check(SSM_FORCED % chunk == 0 and SSM_FORCED // chunk > 1 and (SSM_FORCED - 1) % chunk,
          f"{arch}: {SSM_FORCED} tokens are several chunks of {chunk}, {SSM_FORCED - 1} one")
    tokens = np.random.default_rng(seed + 7).integers(0, cfg.vocab, (1, SSM_FORCED)).astype(np.int32)
    with float32_matmuls():
        model = fresh_model(cfg, device, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill({"tokens": tokens[:, :-1], "max_seq": SSM_FORCED})
        step, _ = model.decode_step(cache, tokens[:, -1], SSM_FORCED - 1)
        del cache
        full, _ = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_logits(step, 1, cfg, f"{arch} teacher forcing")
    err = float((step[:, :cfg.vocab] - full[:, :cfg.vocab]).abs().max())
    scale = float(full[:, :cfg.vocab].abs().max())
    log(f"models [{card}]: {arch} at full width, float32, TF32 off: prefill {SSM_FORCED - 1} (one chunk) + a "
        f"decode step vs a prefill over {SSM_FORCED} tokens ({SSM_FORCED // chunk} chunks of {chunk}): max "
        f"|Δ logit| {err:.3e} (tolerance {SSM_FORCED_TOL[arch]:g}; max |logit| {scale:.2f}); {wall:.2f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(err <= SSM_FORCED_TOL[arch], f"{arch} teacher forcing: {err} > {SSM_FORCED_TOL[arch]}")


def phase_models(tcore, device, seed, card, football_rows, dictionary):
    """The model plane's serving path at full published widths (module
    docstring, phase 10); each model freed before the next."""
    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    with torch.no_grad():
        for part in (lambda: models_serving(tcore, device, seed, card, football_rows, dictionary),
                     lambda: models_param_sync(device, seed, card),
                     lambda: models_ring(device, seed, card),
                     lambda: models_encdec(device, seed, card),
                     lambda: models_vision(device, seed, card),
                     lambda: models_card_vs_cpu(device, seed, card)):
            part()
            gc.collect()
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        for arch in SSM_ARCHS:
            models_state_space(device, seed, card, arch)
            gc.collect()
            torch.cuda.empty_cache()
        # falcon-mamba cut to 2 layers; zamba2 to one group, its shared block and one tail layer
        for arch, n_layers in (("falcon-mamba-7b", 2), ("zamba2-7b", get_config("zamba2-7b").shared_attn_every + 1)):
            models_card_vs_cpu(device, seed, card, arch, n_layers)
            gc.collect()
            torch.cuda.empty_cache()
    log(f"models: phase in {time.perf_counter() - t0:.1f} s, the state-space families {time.perf_counter() - t1:.1f} s "
        "of it")


# ---------------------------------------------------------------------------
# phase 11: training on the replica-to-token path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"
# build_data refreshes its subscription at its 50th batch, where the engine's
# step runs the triple match (K1) and the probe (K2) on the card
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 50, 4, 64
TRAIN_WARMUP = 3  # steps left out of the median step time
EF_STEPS = 3  # ErrorFeedbackInt8(AdamW) steps at full width
# failure and resume at 2 layers: a snapshot every 3 steps, a failure at step
# 4, a new Trainer resumes at 3 and runs steps 4 and 5 (no second snapshot)
RESUME_LAYERS, RESUME_EVERY, RESUME_FAIL, RESUME_MORE = 2, 3, 4, 2
RESUME_TOL = 1e-3  # |step-4 loss resumed - step-4 loss of the failed run| / |loss|, bfloat16 compute
# card vs CPU, 2 layers, float32, TF32 off: each gradient leaf's max |card - CPU| over its largest
# magnitude on the CPU; after one AdamW step the parameters, where the CPU gradient is at least
# STEP_DIRECTED of its leaf's largest (Adam's first step is g / (|g| + eps): its direction is fixed
# by the gradient there, not by rounding), to two float32 ulps of the updated parameter (its own
# rounding) plus STEP_REL of the step lr; elsewhere to 2 lr (a direction flipped by rounding), their
# count reported. The directed elements were first held to 1e-7 absolute and read 1.192e-07 on an
# H100: the norms' scales start at 1, where a float32 ulp is 1.19e-7, and p - lr * delta rounds one
# ulp apart when the deltas differ in their last bits. Two ulps of the updated parameter alone then
# read millions of ulps where p - lr * delta cancels to near 0 and the ulp is tiny, so the bound
# adds a share of the step
GRAD_TOL = 1e-4
STEP_DIRECTED, STEP_REL = 1e-3, 1e-3
SNAPSHOT_HEADROOM = 1.25  # free disk needed, over the snapshot's reckoned bytes


def train_opt(steps):
    """``launch/train``'s optimizer: cosine warm-up to 1e-3 over 10 steps,
    weight decay 0.01, clipping at 1."""
    from repro_torch.optim import AdamW, cosine_warmup

    return AdamW(learning_rate=cosine_warmup(1e-3, 10, steps), weight_decay=0.01, max_grad_norm=1.0)


def train_full_width(device, card):
    """internlm2-1.8b at full width through ``launch/train.main``: 50 steps
    on ``build_data``'s replica-fed batches, one timed snapshot at the end."""
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.runtime import trainer

    cfg = get_config(TRAIN_ARCH)
    snap_bytes = 3 * 4 * cfg.n_params  # float32 parameters, m and v
    (REPO / "build").mkdir(exist_ok=True)
    free = shutil.disk_usage(REPO / "build").free
    log(f"train: disk free under build/ {free / 1e9:.1f} GB; a full-width snapshot reckoned at {snap_bytes / 1e9:.1f} GB")
    check(free >= SNAPSHOT_HEADROOM * snap_bytes, f"train: {free / 1e9:.1f} GB free for a {snap_bytes / 1e9:.1f} GB snapshot")
    saves, writes = [], []
    save, write = trainer.Trainer.save, CheckpointStore.save

    def timed_save(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self)
        saves.append((self.step, time.perf_counter() - t0))

    def timed_write(self, *args, **kw):
        t0 = time.perf_counter()
        write(self, *args, **kw)
        writes.append(time.perf_counter() - t0)

    tmp = Path(tempfile.mkdtemp(prefix="train-", dir=REPO / "build"))
    trainer.Trainer.save, CheckpointStore.save = timed_save, timed_write
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--device", str(device), "--ckpt-dir", str(tmp),
                           "--ckpt-every", str(TRAIN_STEPS)])
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        nbytes = dir_bytes(tmp)
    finally:
        trainer.Trainer.save, CheckpointStore.save = save, write
        shutil.rmtree(tmp, ignore_errors=True)
    loss = np.array([h["loss"] for h in hist])
    dts = np.array([h["dt"] for h in hist])
    check([h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1)), "train: a history record a step")
    check(bool(np.isfinite(loss).all()), f"train: non-finite loss {loss}")
    check(loss[-5:].mean() < loss[:5].mean(), f"train: the loss did not fall: {loss[:5]} ... {loss[-5:]}")
    check(launches["triple_match"] > 0 and launches["merge_probe"] > 0,
          f"train: build_data's refresh launched no K1 or K2 on the card: {launches}")
    check(len(saves) == 1 and saves[0][0] == TRAIN_STEPS, f"train: snapshots {saves}")
    med = float(np.median(dts[TRAIN_WARMUP:]))
    log(f"train [{card}]: {TRAIN_ARCH} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab:,}; {cfg.n_params / 1e9:.3f}B float32 parameters, bfloat16 compute) through launch/train.main: "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} replica tokens, AdamW (cosine warm-up to 1e-3, "
        f"decay 0.01, clip 1)")
    log(f"train [{card}]: step {med * 1e3:.2f} ms median after {TRAIN_WARMUP} warm-up steps (min {dts.min() * 1e3:.2f}, "
        f"max {dts[TRAIN_WARMUP:].max() * 1e3:.2f}; first step {dts[0] * 1e3:.1f} ms), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:,.0f} tokens/s; loss {loss[0]:.4f} -> {loss[-1]:.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches in the run {launches}; main {wall:.1f} s")
    log(f"train [{card}]: snapshot at step {saves[0][0]}: {saves[0][1]:.2f} s, {nbytes / 1e9:.2f} GB "
        f"({nbytes / saves[0][1] / 1e9:.2f} GB/s; params, m and v in the reference's layout): to host arrays "
        f"{saves[0][1] - writes[0]:.2f} s, the store's .npz write {writes[0]:.2f} s")
    check(snap_bytes <= nbytes <= 1.01 * snap_bytes + 2**20, f"train: snapshot of {nbytes} bytes, reckoned {snap_bytes}")
    return launches


def train_error_feedback(device, card, seed):
    """A few ``ErrorFeedbackInt8(AdamW)`` steps at full width, with their peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.compression import ErrorFeedbackInt8

    cfg = get_config(TRAIN_ARCH)
    model = fresh_model(cfg, device, seed)
    opt = ErrorFeedbackInt8(train_opt(TRAIN_STEPS))
    step = make_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    rng = np.random.default_rng(seed + 11)
    losses, times = [], []
    for _ in range(EF_STEPS):
        tokens = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    res = max(float(r.abs().max()) for r in state["residual"].values())
    check(bool(np.isfinite(losses).all()) and np.isfinite(res) and res > 0, f"error feedback: losses {losses}, residual {res}")
    check(int(state["inner"]["step"]) == EF_STEPS, "error feedback: the inner step count")
    log(f"train [{card}]: ErrorFeedbackInt8(AdamW) at full width, {EF_STEPS} steps: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, losses {', '.join(f'{x:.4f}' for x in losses)}, largest "
        f"|residual| {res:.3e}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def train_resume(device, card, seed):
    """internlm2 cut to 2 layers: a failure injected after a snapshot, and a
    new Trainer that resumes from it and continues the history."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    tokens = np.random.default_rng(seed + 12).integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def setup():
        model = fresh_model(cfg, device, seed)
        opt = train_opt(TRAIN_STEPS)
        return make_train_step(model, opt), lambda: (model, opt.init(dict(model.named_parameters())))

    tmp = Path(tempfile.mkdtemp(prefix="resume-", dir=REPO / "build"))
    try:
        tc = TrainerConfig(ckpt_dir=str(tmp), ckpt_every=RESUME_EVERY)
        step, init_state = setup()
        first = Trainer(step, init_state, iter(lambda: batch, None), tc)
        t0 = time.perf_counter()
        try:
            first.run(RESUME_FAIL + 5, inject_failure_at=RESUME_FAIL)
            raise SmokeFailure("resume: the injected failure did not fire")
        except SimulatedFailure:
            pass
        t_first = time.perf_counter() - t0
        nbytes = dir_bytes(tmp)
        failed = first.history
        del first, step, init_state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        step, init_state = setup()
        second = Trainer(step, init_state, iter(lambda: batch, None), tc)
        t_restore = time.perf_counter() - t0
        resumed_at = second.step
        check(resumed_at == RESUME_EVERY, f"resume: resumed at step {resumed_at}, the snapshot is {RESUME_EVERY}")
        hist = second.run(RESUME_MORE)
        steps = [h["step"] for h in hist]
        check(steps == list(range(RESUME_EVERY + 1, RESUME_EVERY + 1 + RESUME_MORE)), f"resume: history steps {steps}")
        gap = abs(hist[0]["loss"] - failed[RESUME_EVERY]["loss"]) / abs(failed[RESUME_EVERY]["loss"])
        check(all(np.isfinite(h["loss"]) for h in hist), "resume: finite losses")
        log(f"train [{card}]: failure and resume, {TRAIN_ARCH} cut to {RESUME_LAYERS} layers (bfloat16 compute): "
            f"failed at step {RESUME_FAIL} after a snapshot at {RESUME_EVERY} ({nbytes / 1e9:.2f} GB; "
            f"{t_first:.1f} s with it), a new Trainer resumed at {resumed_at} in {t_restore:.1f} s and ran steps "
            f"{steps}; step {RESUME_EVERY + 1} loss {hist[0]['loss']:.5f} resumed vs {failed[RESUME_EVERY]['loss']:.5f} "
            f"before the failure (relative gap {gap:.2e}, tolerance {RESUME_TOL:g})")
        check(gap <= RESUME_TOL, f"resume: step {RESUME_EVERY + 1} loss gap {gap} > {RESUME_TOL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_card_vs_cpu(device, card, seed):
    """internlm2 cut to 2 layers, float32, TF32 off: the gradients of one
    ``train_loss`` and the parameters after one AdamW step on the card and
    on the CPU from the same weights; ``quantize_int8`` of every card
    gradient on both, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.compression import quantize_int8

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS, dtype="float32")
    tokens = np.random.default_rng(seed + 13).integers(0, cfg.vocab, (SYNC_BATCH, SYNC_SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    opt = train_opt(TRAIN_STEPS)
    lr = float(opt.learning_rate(1))
    got = {}
    with float32_matmuls():
        on_card = fresh_model(cfg, device, seed)
        on_cpu = build_model(cfg, "cpu")
        on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
        for where, model in (("card", on_card), ("cpu", on_cpu)):
            t0 = time.perf_counter()
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            loss, _ = model.train_loss(batch)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            opt.update(grads, opt.init(params), params)
            got[where] = (float(loss.detach()), grads, params, time.perf_counter() - t0)
    loss_gap = abs(got["card"][0] - got["cpu"][0])
    grad_gap, step_gap, step_excess, flipped, n_el, q_equal = 0.0, 0.0, 0.0, 0, 0, True
    with torch.no_grad():
        for name, g_cpu in got["cpu"][1].items():
            g_card = got["card"][1][name]
            scale = float(g_cpu.abs().max()) or 1.0
            grad_gap = max(grad_gap, float((g_card.cpu() - g_cpu).abs().max()) / scale)
            p_cpu = got["cpu"][2][name].abs()
            dp = (got["card"][2][name].cpu() - got["cpu"][2][name]).abs()
            ulp = torch.nextafter(p_cpu, torch.full_like(p_cpu, float("inf"))) - p_cpu
            excess = (dp - 2 * ulp).clamp(min=0) / lr  # beyond the parameter's own rounding, in steps
            directed = g_cpu.abs() >= STEP_DIRECTED * scale
            if bool(directed.any()):
                step_gap = max(step_gap, float(dp[directed].max()))
                step_excess = max(step_excess, float(excess[directed].max()))
            flipped += int((excess[~directed] > STEP_REL).sum())
            n_el += dp.numel()
            check(float(dp.max()) <= 2 * lr * 1.01, f"card vs CPU: {name} moved {float(dp.max())} apart after one step")
            q_card, s_card = quantize_int8(g_card)
            q_cpu, s_cpu = quantize_int8(g_card.cpu())
            q_equal &= torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu)
    log(f"train [{card}]: card vs CPU, {TRAIN_ARCH} cut to {RESUME_LAYERS} layers, float32, TF32 off, batch "
        f"{SYNC_BATCH} x {SYNC_SEQ}: |Δ loss| {loss_gap:.3e}; gradients max |Δ| / leaf max {grad_gap:.3e} "
        f"(tolerance {GRAD_TOL:g}); after one AdamW step (lr {lr:.1e}) max |Δ param| where the direction is set "
        f"{step_gap:.3e}, beyond two ulps of the parameter {step_excess:.3e} of the step (tolerance {STEP_REL:g}), "
        f"{flipped:,} of {n_el:,} other elements beyond it; quantize_int8 "
        f"of every gradient {'bit-identical' if q_equal else 'DIFFERENT'}; card {got['card'][3]:.2f} s, CPU "
        f"{got['cpu'][3]:.2f} s")
    check(grad_gap <= GRAD_TOL, f"card vs CPU gradients: {grad_gap} > {GRAD_TOL}")
    check(step_excess <= STEP_REL, f"card vs CPU after one step: {step_excess} of the step > {STEP_REL}")
    check(q_equal, "card vs CPU: quantize_int8 differs")


def phase_train(device, seed, card):
    """Training on the replica-to-token path (module docstring, phase 11)."""
    import torch

    t0 = time.perf_counter()
    launches = train_full_width(device, card)
    for part in (lambda: train_error_feedback(device, card, seed),
                 lambda: train_resume(device, card, seed),
                 lambda: train_card_vs_cpu(device, card, seed)):
        gc.collect()
        torch.cuda.empty_cache()
        part()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: phase in {time.perf_counter() - t0:.1f} s")
    return launches


def four_ways(bgp, ogp):
    """One interest written four ways: as is, with its variables renamed,
    with its BGP patterns reordered, and both."""

    def rename(pats):
        return [tuple(t + "_" if t.startswith("?") else t for t in p) for p in pats]

    return [(bgp, ogp), (rename(bgp), rename(ogp)), (bgp[::-1], ogp), (rename(bgp)[::-1], rename(ogp))]


def phase_fanout(tcore, device, seed, stream, broker_stats):
    """256 eager subscribers over the broker phase's dump, drawn from 10
    interests (Football, Location, 8 categories) each written four ways:
    round robin over the 40 expressions first, then Zipf (s = 1.3) as
    ``benchmarks/broker_fanout.py`` draws subscribers. All subscribe before
    the first changeset with equal capacities and their interest's τ0, so
    canonical duplicates join one lane group; every fire evaluates 10 slots
    for 256 deliveries, and every member equals its group and IrapEngine on
    its own expression."""
    import torch

    football_caps, location_caps, category_caps = broker_capacities(tcore)
    interests = [("football", FOOTBALL, football_caps, stream.football_init),
                 ("location", LOCATION, location_caps, stream.location_init)]
    cat_inits = category_targets(stream)
    interests += [(f"category{k}", category_interest(k), category_caps, cat_inits[k])
                  for k in range(FANOUT_CATEGORIES)]
    pool = [(i, w) for w in range(4) for i in range(len(interests))]  # as-is writings first
    rng = np.random.default_rng(seed + 7)
    draw = list(range(len(pool))) + list((rng.zipf(ZIPF_S, FANOUT_SUBSCRIBERS - len(pool)) - 1) % len(pool))
    changesets = [stream.changeset() for _ in range(FANOUT_CHANGESETS)]

    def expr_of(i, w):
        name, (bgp, ogp), _, _ = interests[i]
        return tcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://fanout/{name}", *four_ways(bgp, ogp)[w])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    broker = tcore.Broker(stream.d, device=device)
    subs = []
    for e in draw:
        i, w = pool[e]
        _, _, caps, init = interests[i]
        subs.append((e, broker.subscribe(expr_of(i, w), caps, initial_target=init)))
    sub_s = time.perf_counter() - t0
    groups = {}
    for e, sub in subs:
        groups.setdefault(id(sub.share_tag), set()).add(pool[e][0])
    check(len(groups) == len(interests) and all(len(g) == 1 for g in groups.values()),
          f"the {len(subs)} subscribers form {len(groups)} lane groups, one an interest")
    per_interest = [sum(1 for e, _ in subs if pool[e][0] == i) for i in range(len(interests))]
    log(f"fan-out: {len(subs)} subscribers of {len(interests)} interests x 4 writings ({len(set(draw))} "
        f"expressions drawn; per interest {per_interest}) subscribed in {sub_s:.1f} s, {len(groups)} lane groups")

    outs = []
    for d_np, a_np in changesets:
        outs.append(broker.process_changeset(d_np, a_np))
        st = broker.stats[-1]
        check(st.distinct_interests == len(interests) and st.fanout_copies == FANOUT_SUBSCRIBERS,
              f"a fan-out fire evaluated {st.distinct_interests} slots for {st.fanout_copies} deliveries")
    torch.cuda.synchronize()
    eager = [st.elapsed_s * 1e3 for st in broker_stats[:BROKER_CHANGESETS]]
    log("fan-out: ms per fire " + ", ".join(f"{st.elapsed_s * 1e3:.1f}" for st in broker.stats)
        + f" ({len(interests)} slots, {FANOUT_SUBSCRIBERS} deliveries, {broker.stats[-1].n_cohort_passes} cohort "
        f"passes a fire); the 48-subscriber broker's changesets: " + ", ".join(f"{ms:.1f}" for ms in eager))

    # every member against its group's root, then IrapEngine on its own expression
    roots = {}
    for k, (e, sub) in enumerate(subs):
        roots.setdefault(id(sub.share_tag), k)
    engines = {}
    t0 = time.perf_counter()
    for e in sorted(set(draw)):
        i, w = pool[e]
        _, _, caps, init = interests[i]
        eng = tcore.IrapEngine(stream.d, device=device).register_interest(expr_of(i, w), caps, initial_target=init)
        engines[e] = [eng.apply(d_np, a_np) for d_np, a_np in changesets] + [(eng.tau, eng.rho)]
    checked = 0
    for c, call in enumerate(outs):
        for k, (e, sub) in enumerate(subs):
            got, root = call[k], call[roots[id(sub.share_tag)]]
            want = engines[e][c]
            for f in OUT_FIELDS:
                check(same_rows(getattr(got, f), getattr(root, f)), f"fan-out member {k} call {c}: {f} != its group's")
                check(same_rows(getattr(got, f), getattr(want, f)), f"fan-out member {k} call {c}: {f} != IrapEngine")
            checked += 1
    for k, (e, sub) in enumerate(subs):
        tau, rho = engines[e][-1]
        check(same_rows(sub.tau, tau) and same_rows(sub.rho, rho), f"fan-out member {k}: τ/ρ != IrapEngine")
    log(f"fan-out: {checked} member fires equal their group and IrapEngine on {len(engines)} original expressions "
        f"({time.perf_counter() - t0:.1f} s)")


def time_cuda(fn, iters: int, flush) -> float:
    """Median ms of ``fn`` on the card, with L2 flushed before each launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launch_floor(device, flush) -> float:
    """Median ms of a launch that does no real work (a one-element fill),
    timed as the kernels are: the floor under a few-µs bound."""
    import torch

    one = torch.empty(1, dtype=torch.int32, device=device)
    ms = time_cuda(lambda: one.fill_(0), 50, flush)
    log(f"timing: launch floor (one-element fill, L2 flushed as for the kernels): {ms:.4f} ms")
    return ms


def phase_timing(tcore, device, subs, changesets, launches):
    import torch
    from repro_torch.kernels import merge_join, ref, triple_match

    scratch = torch.empty(1 << 28, dtype=torch.uint8, device=device)  # 256 MiB > 50 MB L2
    flush = lambda: scratch.zero_()  # noqa: E731
    loc = subs["location"]
    caps = loc.caps
    # K1 at the A side of Location's last changeset: I = A ∪ ρ at capacity n_i
    a_store, _ = tcore.from_array(torch.as_tensor(changesets[-1][1], device=device), caps.n_added)
    i_set, _ = tcore.union(a_store, loc.rho, caps.n_i)
    spo = i_set.spo
    pats = torch.as_tensor(loc.plan.patterns, device=device)
    n, p = spo.shape[0], pats.shape[0]
    got = triple_match.triple_match_cuda(spo, pats)
    want = ref.pattern_bitmask_ref(spo, pats)
    k1_err = int((got.long() - want.long()).abs().max())
    check(k1_err == 0, "triple_match at the main-path shape")
    k1 = {
        "name": "triple_match", "route": "cuda", "source": "src/repro_torch/csrc/triple_match.cu",
        "replaces": "src/repro/kernels/triple_match.py:158", "launches": launches["triple_match"],
        "max_abs_err": k1_err,
        "ms": time_cuda(lambda: triple_match.triple_match_cuda(spo, pats), 50, flush),
        "plain_ms": time_cuda(lambda: ref.pattern_bitmask_ref(spo, pats), 10, flush),
    }
    k1_bytes = n * 12 + p * 12 + n * 4
    k1_ops = n * p * 7  # per pattern: 3 compares, 3 wildcard tests folded, 1 or
    k1["bound_ms"], k1["bound_by"] = bound(k1_bytes, k1_ops)
    k1["library_ms"] = None  # no single PyTorch call computes a multi-pattern bitset
    log(f"timing: triple_match N={n:,} P={p}: {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
        f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")

    # K2/K3 at two main-path shapes
    tau = loc.tau.spo
    r_prime = loc.last_outputs.r_prime.spo
    subjects = torch.unique(i_set.spo[:, 0])
    subjects = subjects[subjects != tcore.PAD][: caps.dedup_candidates]
    lo_q = torch.full((caps.dedup_candidates, 3), tcore.PAD, dtype=torch.int32, device=device)
    lo_q[: subjects.shape[0], 0] = subjects
    lo_q[: subjects.shape[0], 1:] = int(np.iinfo(np.int32).min)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shuffled = lo_q[torch.randperm(lo_q.shape[0], device=device, generator=gen)]
    shapes = {
        # difference(τ, r'): every τ row probed into the pulled set
        "member": (r_prime, tau),
        # prefix_range over τ by subject: the evaluator's candidate probes
        "prefix": (tau, lo_q),
        # the same queries in random order: the unsorted path
        "prefix shuffled": (tau, shuffled),
    }
    k2_rows = {}
    for label, (store, queries) in shapes.items():
        counts = torch.zeros(3, dtype=torch.int32, device=device)
        idx, found = merge_join.merge_probe_cuda(store, queries, "left", tile_counts=counts)
        w_idx, w_found = ref.merge_probe_ref(store, queries)
        err = max(int((idx.long() - w_idx.long()).abs().max()),
                  int((found.long() - w_found.long()).abs().max()))
        check(err == 0, f"merge_probe at the {label} shape")
        c, q = store.shape[0], queries.shape[0]
        rows = answer_rows(c, w_idx)
        row = {
            "ms": time_cuda(lambda: merge_join.merge_probe_cuda(store, queries, "left"), 30, flush),
            "plain_ms": time_cuda(lambda: ref.merge_probe_ref(store, queries), 5, flush),
            "max_abs_err": err,
        }
        # bytes: the store rows any correct answer reads (idx - 1 and idx of
        # each query, each row once), the queries read once, idx and found
        # written once; operations: per query, two 3-column compares of ~8
        # int32 operations (with the row at idx - 1 and at idx)
        row["bound_ms"], row["bound_by"] = bound(rows * 12 + q * 12 + q * 5, q * 16)
        k2_rows[label] = row
        log(f"timing: merge_probe {label} S={c:,} Q={q:,} (answer rows {rows:,}; tiles "
            + ", ".join(f"{p} {n:,}" for p, n in zip(merge_join.TILE_PATHS, counts.tolist()))
            + f"): {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

    # range mode at the prefix shape (prefix_range, depth 1) against the two
    # single-side launches it replaces
    hi_q = lo_q.clone()
    hi_q[:, 1:] = tcore.PAD
    lo_r = lo_q.clone()
    lo_r[:, 1:] = int(np.iinfo(np.int32).min)
    counts = torch.zeros(3, dtype=torch.int32, device=device)
    start, end = merge_join.merge_probe_range_cuda(tau, lo_r, hi_q, tile_counts=counts)
    w_start, w_end = ref.merge_probe_range_ref(tau, lo_r, hi_q)
    check(torch.equal(start, w_start) and torch.equal(end, w_end), "merge_probe range at the prefix shape")
    q = lo_r.shape[0]
    rows = answer_rows(tau.shape[0], w_start, w_end)
    range_ms = time_cuda(lambda: merge_join.merge_probe_range_cuda(tau, lo_r, hi_q), 30, flush)
    two_ms = time_cuda(lambda: (merge_join.merge_probe_cuda(tau, lo_r, "left"),
                                merge_join.merge_probe_cuda(tau, hi_q, "right")), 30, flush)
    r_bound, r_by = bound(rows * 12 + q * 24 + q * 8, q * 32)
    log(f"timing: merge_probe range (prefix shape) S={tau.shape[0]:,} Q={q:,} (answer rows {rows:,}; tiles "
        + ", ".join(f"{p} {n:,}" for p, n in zip(merge_join.TILE_PATHS, counts.tolist()))
        + f"): one range launch {range_ms:.4f} ms, left + right launches {two_ms:.4f} ms, "
        f"bound {r_bound:.4f} ms ({r_by})")
    k2 = {
        "name": "merge_probe", "route": "cuda", "source": "src/repro_torch/csrc/merge_probe.cu",
        "replaces": "src/repro/kernels/merge_join.py:81", "launches": launches["merge_probe"],
        **k2_rows["member"],
        "library_ms": None,  # no single PyTorch call searches rows lexicographically
    }
    # K3 (the windowed probe) is the same CUDA kernel and launch counter; its
    # row reads the prefix_range shape, left side
    k3 = {
        "name": "merge_probe_windowed", "route": "cuda", "source": "src/repro_torch/csrc/merge_probe.cu",
        "replaces": "src/repro/kernels/merge_join.py:131", "launches": launches["merge_probe"],
        **k2_rows["prefix"], "library_ms": None,
    }
    return [k1, k2, k3]


def bank_timing(rec, launches, flush):
    """K4 at the flush fire's deleted-side shape, and K5 at the category
    cohort's widest added-side shape and at the broker's widest lanes pass
    by bytes, as the broker's main path gave them."""
    import torch
    from repro_torch.core.triples import PAD
    from repro_torch.kernels import ref, triple_match_words

    spo, bank = rec.words_args
    n, n_pat = spo.shape[0], bank.shape[0]
    w = max(1, -(-n_pat // 32))
    # the work this run's data needs: valid rows against live bank rows
    # (PAD rows and all-PAD bank rows, padding and tombstones, match nothing)
    n_valid = int((spo[:, 0] != PAD).sum())
    n_live = int((bank != PAD).any(dim=1).sum())
    got = triple_match_words.triple_match_words_cuda(spo, bank)
    err = int((got.long() - ref.pattern_bitmask_words_ref(spo, bank).long()).abs().max())
    check(err == 0, "triple_match_words at the main-path shape")
    k4 = {
        "name": "triple_match_words", "route": "cuda", "source": "src/repro_torch/csrc/triple_match_words.cu",
        "replaces": "src/repro/kernels/triple_match.py:187", "launches": launches["triple_match_words"],
        "max_abs_err": err,
        "ms": time_cuda(lambda: triple_match_words.triple_match_words_cuda(spo, bank), 50, flush),
        "plain_ms": time_cuda(lambda: ref.pattern_bitmask_words_ref(spo, bank), 10, flush),
    }
    # bytes: each row read once and its W words written once. operations,
    # as the slot-mask design needs them: three table lookups and W ANDs a
    # valid row
    k4_bytes = n * (12 + 4 * w) + n_pat * 12
    k4["bound_ms"], k4["bound_by"] = bound(k4_bytes, n_valid * (3 + w))
    # the bound stated for the earlier per-slot kernel: per valid row and
    # live bank row ~7 operations (3 compares, 3 wildcard tests, 1 or)
    k4["old_bound_ms"], k4["old_bound_by"] = bound(k4_bytes, n_valid * n_live * 7)
    k4["library_ms"] = None  # no single PyTorch call computes a multi-pattern bank bitset
    log(f"timing: triple_match_words N={n:,} ({n_valid:,} valid) W={w} ({n_live} live bank rows): "
        f"{k4['ms']:.4f} ms, plain {k4['plain_ms']:.4f} ms, "
        f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}); old per-slot bound {k4['old_bound_ms']:.4f} ms "
        f"({k4['old_bound_by']})")

    k5 = {
        "name": "triple_match_lanes", "route": "cuda", "source": "src/repro_torch/csrc/triple_match_lanes.cu",
        "replaces": "src/repro/kernels/triple_match.py:373", "launches": launches["triple_match_lanes"],
    }
    table = lanes_timing(rec.lanes_args, flush)
    k5.update((key, table[key]) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"))
    k5["library_ms"] = None  # no single PyTorch call computes lane-routed bank bits
    log(f"timing: triple_match_lanes R={table['r']} ({table['active']} active, {table['valid_rows']:,} valid rows) "
        f"N={table['n']:,} nt={table['nt']}: {k5['ms']:.4f} ms, "
        f"plain {k5['plain_ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms ({k5['bound_by']})")
    # the widest lanes pass by bytes, where the launch floor is a small share
    wide = k5["widest_pass"] = lanes_timing(rec.lanes_wide_args, flush)
    log(f"timing: triple_match_lanes at the widest pass R={wide['r']} ({wide['active']} active, "
        f"{wide['valid_rows']:,} valid rows) N={wide['n']:,} nt={wide['nt']}: {wide['ms']:.4f} ms, "
        f"plain {wide['plain_ms']:.4f} ms, bound {wide['bound_ms']:.4f} ms ({wide['bound_by']}, "
        f"{wide['bound_ms'] / wide['ms']:.1%} of it)")
    torch.cuda.synchronize()
    return [k4, k5]


def lanes_timing(args, flush) -> dict:
    """K5 on one lanes pass's inputs, as the broker's main path gave them:
    its time, its plain version's and its bound, with the pass's shape."""
    import torch
    from repro_torch.core.triples import PAD
    from repro_torch.kernels import ref, triple_match_lanes

    spo_b, bank, lanes, active = args
    r, n, nt = spo_b.shape[0], spo_b.shape[1], lanes.shape[1]
    if active is None:
        active = torch.ones(r, dtype=torch.int32, device=spo_b.device)
    r_active = int(active.sum())
    n_valid = int(((spo_b[..., 0] != PAD) & (active[:, None] != 0)).sum())
    got = triple_match_lanes.triple_match_lanes_cuda(spo_b, bank, lanes, active)
    err = int((got.long() - ref.pattern_lane_bits_ref(spo_b, bank, lanes, active).long()).abs().max())
    check(err == 0, f"triple_match_lanes at the main-path shape R={r} N={n} nt={nt}")
    row = {"r": r, "n": n, "nt": nt, "active": r_active, "valid_rows": n_valid, "max_abs_err": err,
           "ms": time_cuda(lambda: triple_match_lanes.triple_match_lanes_cuda(spo_b, bank, lanes, active), 50, flush),
           "plain_ms": time_cuda(lambda: ref.pattern_lane_bits_ref(spo_b, bank, lanes, active), 10, flush)}
    # active members' rows read once, every member's word written once; the
    # nt compares only for active members' valid rows
    row["bound_ms"], row["bound_by"] = bound(r_active * n * 12 + r * n * 4, n_valid * nt * 7)
    return row


def chain_timing(rec, launches, flush):
    """K6 at the flush's union shape and K7 at the flush's refine shape (its
    frontier planes over the union rows), as the broker's main path gave them."""
    import torch
    from repro_torch.core.triples import PAD
    from repro_torch.kernels import lane_refine, ref, triple_match_words_segmented

    spo, bank, seg, n_seg = rec.seg_args
    n, n_pat = spo.shape[0], bank.shape[0]
    w = max(1, -(-n_pat // 32))
    # the work this run's data needs: valid rows of some segment against
    # live bank rows (PAD rows, rows of no segment and all-PAD bank rows
    # give zero words)
    member = (seg & ((1 << n_seg) - 1 if n_seg < 32 else -1)) != 0
    n_valid = int(((spo[:, 0] != PAD) & member).sum())
    n_live = int((bank != PAD).any(dim=1).sum())
    got = triple_match_words_segmented.triple_match_words_segmented_cuda(spo, bank, seg, n_seg)
    err = int((got.long() - ref.pattern_bitmask_words_segmented_ref(spo, bank, seg, n_seg).long()).abs().max())
    check(err == 0, "triple_match_words_segmented at the main-path shape")
    k6 = {
        "name": "triple_match_words_segmented", "route": "cuda",
        "source": "src/repro_torch/csrc/triple_match_words_segmented.cu",
        "replaces": "src/repro/kernels/triple_match.py:222", "launches": launches["triple_match_words_segmented"],
        "max_abs_err": err,
        "ms": time_cuda(lambda: triple_match_words_segmented.triple_match_words_segmented_cuda(spo, bank, seg, n_seg),
                        50, flush),
        "plain_ms": time_cuda(lambda: ref.pattern_bitmask_words_segmented_ref(spo, bank, seg, n_seg), 10, flush),
    }
    # bytes: each row and its seg word read once (16 B), every plane's words
    # written once. operations, as the slot-mask design needs them: three
    # table lookups a valid member row, W ANDs a valid row and plane
    k6_bytes = n * 16 + n_seg * n * w * 4 + n_pat * 12
    k6["bound_ms"], k6["bound_by"] = bound(k6_bytes, n_valid * (3 + n_seg * w))
    # the bound stated for the earlier per-slot kernel: per valid member row
    # and live bank row ~7 operations
    k6["old_bound_ms"], k6["old_bound_by"] = bound(k6_bytes, n_valid * n_live * 7)
    k6["library_ms"] = None  # no single PyTorch call computes segment-masked bank bitsets
    log(f"timing: triple_match_words_segmented N={n:,} ({n_valid:,} valid members) n_seg={n_seg} W={w} "
        f"({n_live} live bank rows): {k6['ms']:.4f} ms, plain {k6['plain_ms']:.4f} ms, "
        f"bound {k6['bound_ms']:.4f} ms ({k6['bound_by']}); old per-slot bound {k6['old_bound_ms']:.4f} ms "
        f"({k6['old_bound_by']})")

    spo, words, parents, residual = rec.refine_args
    planes = words.shape[0] if words.ndim == 3 else 1
    n, w = words.shape[-2], words.shape[-1]
    vp = parents.shape[0]
    wv = max(1, -(-vp // 32))
    shared = spo.ndim == 2
    n_valid = int((spo[..., 0] != PAD).sum()) * (planes if shared else 1)
    n_live = int((parents >= 0).sum())
    got = lane_refine.lane_refine_cuda(spo, words, parents, residual)
    err = int((got.long() - ref.lane_refine_ref(spo, words, parents, residual).long()).abs().max())
    check(err == 0, "lane_refine at the main-path shape")
    k7 = {
        "name": "lane_refine", "route": "cuda", "source": "src/repro_torch/csrc/lane_refine.cu",
        "replaces": "src/repro/kernels/triple_match.py:322", "launches": launches["lane_refine"],
        "max_abs_err": err,
        "ms": time_cuda(lambda: lane_refine.lane_refine_cuda(spo, words, parents, residual), 50, flush),
        "plain_ms": time_cuda(lambda: ref.lane_refine_ref(spo, words, parents, residual), 10, flush),
    }
    # bytes: the rows read once (once for all planes when they share them),
    # each plane's real words read and virtual words written once.
    # operations, as the slot-mask design needs them: three table lookups a
    # valid row, Wv ORs a set parent bit that has children, Wv ANDs a valid
    # plane row
    spo_bytes = n * 12 * (1 if shared else planes)
    n_bytes = spo_bytes + planes * n * (4 * w + 4 * wv) + vp * 16
    n_rows = int((spo[..., 0] != PAD).sum())
    lanes = parents[(parents >= 0) & (parents < 32 * w)].long().unique().tolist()
    has_children = torch.zeros(w, dtype=torch.int64, device=words.device)
    for lane in lanes:
        has_children[lane // 32] |= 1 << (lane % 32)
    masked = (words.long() & 0xFFFFFFFF) & has_children
    set_bits = sum(int(((masked >> b) & 1).sum()) for b in range(32))
    k7["bound_ms"], k7["bound_by"] = bound(n_bytes, 3 * n_rows + set_bits * wv + n_valid * wv)
    # the bound stated for the earlier per-slot kernel: per valid row of a
    # plane and live slot ~10 operations (word select, shift, three
    # compares, the ands); kept beside the restated one
    k7["old_bound_ms"], k7["old_bound_by"] = bound(n_bytes, n_valid * n_live * 10)
    k7["library_ms"] = None  # no single PyTorch call refines lane bits by residual compares
    log(f"timing: lane_refine F={planes} N={n:,} ({n_valid:,} valid plane rows, rows shared {shared}) W={w} "
        f"Vp={vp} ({n_live} live, {len(lanes)} parent lanes, {set_bits:,} set parent bits with children): "
        f"{k7['ms']:.4f} ms, plain {k7['plain_ms']:.4f} ms, "
        f"bound {k7['bound_ms']:.4f} ms ({k7['bound_by']}); old per-slot bound {k7['old_bound_ms']:.4f} ms "
        f"({k7['old_bound_by']})")
    torch.cuda.synchronize()
    return [k6, k7]


def profile_call(label: str, fn) -> None:
    """Run ``fn`` once under torch.profiler: the device's busy share of the
    wall time, and device time by kernel group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    if not rows:
        log(f"profile {label}: wall {wall_ms:.1f} ms; device time not measured (no device events)")
        return
    groups = {}
    for key, _, ms in rows:
        k = key.lower()
        # K4 and K6 share one kernel template, bank_words_kernel<kSeg, kCW>,
        # named demangled or mangled (ILb1E: kSeg true)
        if "bank_words_kernel<true" in k or "bank_words_kernelilb1" in k:
            k = "segmented"
        elif "bank_words_kernel" in k:
            k = "triple_match_words"
        group = ("triple_match_words_segmented kernel" if "segmented" in k else
                 "lane_refine kernel" if "lane_refine" in k else
                 "triple_match_words kernel" if "triple_match_words" in k else
                 "triple_match_lanes kernel" if "triple_match_lanes" in k else
                 "triple_match kernel" if "triple_match" in k else
                 "merge_probe kernel" if "merge_probe" in k else
                 "gemm" if "gemm" in k or "xmma" in k or "cutlass" in k or "nvjet" in k else
                 "sort" if "sort" in k or "radix" in k else
                 "index/scatter/gather" if "index" in k or "scatter" in k or "gather" in k else
                 "copy/fill" if "memcpy" in k or "memset" in k or "fill" in k or "copy" in k else
                 "reduce/scan" if "reduce" in k or "scan" in k else "elementwise/other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(c for _, c, _ in rows)} device ops; by group: "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:8]:
        log(f"  {ms:8.3f} ms  x{count:<5d} {key[:110]}")


def phase_profile(subs, stream, broker, broker_stream):
    """One more changeset per interest, and one more broker fire, profiled."""
    d_np, a_np = stream.changeset()
    for name, sub in subs.items():
        profile_call(name, lambda: sub.apply(d_np, a_np))
    d_np, a_np = broker_stream.changeset()
    fired = []
    profile_call("broker fire (default configuration)", lambda: fired.append(broker.process_changeset(d_np, a_np)))
    st = broker.stats[-1]
    log(f"  broker fire: {st.n_evaluated} subscribers fired, {st.n_cohort_passes} cohort passes")


def answer_rows(c: int, *positions) -> int:
    """Distinct store rows that any correct probe must read for these
    answers: the rows at p - 1 and p of each answer p (those inside
    [0, c)), each row once."""
    import torch

    pos = torch.cat([p.long() for p in positions])
    pos = torch.cat([pos - 1, pos])
    return int(torch.unique(pos[(pos >= 0) & (pos < c)]).shape[0])


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--changesets", type=int, default=3)
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 3
    from repro_torch import core as tcore

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    card = phase_build()
    phase_kernels(device)
    phase_small(tcore, device, args.seed)
    subs, stream, changesets, launches = phase_full(tcore, device, args.seed, args.changesets)
    football_rows, football_dictionary = tcore.to_numpy(subs["football"].tau), stream.d
    broker, broker_stream, rec, broker_launches = phase_broker(tcore, device, args.seed)
    phase_fanout(tcore, device, args.seed, broker_stream, broker.stats)
    table = phase_timing(tcore, device, subs, changesets, launches)
    scratch = torch.empty(1 << 28, dtype=torch.uint8, device=device)  # 256 MiB > 50 MB L2
    table += bank_timing(rec, broker_launches, scratch.zero_)
    table += chain_timing(rec, broker_launches, scratch.zero_)
    floor_ms = launch_floor(device, scratch.zero_)
    for row in table:
        row["launch_floor_ms"] = floor_ms
    del scratch, rec
    phase_profile(subs, stream, broker, broker_stream)
    del subs, stream, changesets, broker, broker_stream
    gc.collect()  # a broker's step closures refer back to it
    torch.cuda.empty_cache()
    phase_durable(tcore, device, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_sharded(tcore, device, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_models(tcore, device, args.seed, card, football_rows, football_dictionary)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(device, args.seed, card)
    mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    check(not mods, f"the port loaded JAX or the JAX package: {mods}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
