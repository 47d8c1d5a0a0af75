"""repro_torch's Broker against repro's under its non-default options (CPU, exact).

Each case gives both brokers the same constructor argument and drives them
through one script (``tests/test_torch_broker.py``'s runner); every step's
stores, states, statistics and counters must be equal. Two configurations:

* ``LATTICE_OFF`` (the lattice and the delta chain off): this file runs the
  first two cases below, ``test_torch_broker_hooks.py`` the other two (each
  case compiles its own reference steps, so one file would take too long);
* the default configuration (subsumption lattice, delta frontier chains):
  all four cases over one script whose interests form a lane group, a
  contained interest (a virtual lane) and two deferred frontiers.

The cases, with ``LATTICE_OFF``:

* ``max_fire_retries=0``: the tiny-caps subscriber of the paper example
  overflows, so its fire goes through the per-interest fallback
  (``_degraded_eval``) at once;
* ``deferred_device_resident=False``: fired batches go through host arrays
  and the closing flush evaluates one frontier a pass;
* ``matcher``: the bank words come from a custom single-word matcher, so
  cohort steps take the composed words + routing path;
* ``decay_patience=1``: a deferred batch grown by a duplicate-heavy burst
  shrinks at the first under-filled drain.

In the default configuration (``lattice_script``):

* ``matcher`` feeds the segmented words pass over the delta chain's union,
  whose real words ``lane_refine`` refines into the virtual lane's;
* ``deferred_device_resident=False`` turns the chain off: the closing
  flush's two frontiers take one stacked pass each;
* ``max_fire_retries=0`` sends an overflowing lane group (two members, one
  slot) through ``_degraded_eval``, and its outputs fan out to both;
* ``decay_patience=1`` shrinks the deferred batch at each first
  under-filled drain (three times here, once at the default patience), and that
  batch then goes through the chain, homed at its own row count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_broker import A, EMPTY, LATTICE_OFF, assert_runs_equal, paper_script, run_script  # noqa: E402


class CountingMatcher:
    """The plain single-word bank match of one package, counting its calls."""

    def __init__(self, ref):
        self.ref, self.calls = ref, 0

    def __call__(self, spo, patterns):
        self.calls += 1
        return self.ref.pattern_bitmask_ref(spo, patterns)


def burst_script():
    """Two deferred subscribers; a burst grows their shared batch, and each
    explicit drain of the first is a decay check on the second's batch."""
    d = jcore.Dictionary()
    for t in ("c:Athlete", "c:Team", "p:goals", "p:rank"):
        d.encode_term(t)
    tau0 = d.encode_triples([("e:1", A, "c:Athlete"), ("e:1", "p:goals", "10"), ("e:2", A, "c:Team")])
    rng = np.random.default_rng(0)

    def burst(n_raw, n_distinct):
        pool = [(f"e:{i % 50}", "p:goals", str(1000 + i)) for i in range(n_distinct)]
        return d.encode_triples([pool[rng.integers(0, n_distinct)] for _ in range(n_raw)])

    caps = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
    goals = ([("?a", A, "c:Athlete"), ("?a", "p:goals", "?v")], [])
    ranks = ([("?a", A, "c:Team"), ("?a", "p:rank", "?v")], [])
    rows = [burst(8, 8), burst(200, 24), burst(4, 4), burst(4, 4)]
    terms = [d.decode(i) for i in range(len(d))]
    script = [
        ("sub", "x", goals, caps, ("stale",), tau0, False),
        ("sub", "y", ranks, caps, ("stale",), tau0, False),
        ("cs", EMPTY, rows[0]),
        ("cs", EMPTY, rows[1]),
        ("cs", EMPTY, rows[2]),
        ("flush", ["x"]),
        ("cs", EMPTY, rows[3]),
        ("flush", ["x"]),
        ("flush",),
    ]
    return terms, script


def lattice_script():
    """Five subscribers: a stale lane group ``x``/``x#2`` (one written with
    other variable names) and a stale interest contained by it (``c``, a
    virtual lane), all three on one frontier until ``x`` alone is flushed;
    and an eager lane group ``t``/``t#2`` with capacities that overflow.
    Two duplicate-heavy bursts grow the deferred batch."""
    d = jcore.Dictionary()
    for term in ("c:Athlete", "p:goals", "e:0", "e:1"):
        d.encode_term(term)
    tau0 = d.encode_triples([("e:0", A, "c:Athlete"), ("e:0", "p:goals", "10"), ("e:1", "p:goals", "20")])
    rng = np.random.default_rng(0)

    def burst(n_raw, n_distinct, base):
        pool = [(f"e:{i % 3}", "p:goals", str(base + i)) for i in range(n_distinct)]
        return d.encode_triples([pool[rng.integers(0, n_distinct)] for _ in range(n_raw)])

    caps = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
    tiny = dict(n_removed=16, n_added=16, tau=4, rho=4, pulls=4)
    goals = ([("?a", "p:goals", "?v")], [])
    renamed = ([("?x", "p:goals", "?y")], [])
    contained = ([("e:0", "p:goals", "?v")], [])
    rows = [burst(8, 8, 100), burst(200, 24, 200), burst(200, 20, 300)]
    gone = d.encode_triples([("e:1", "p:goals", "20")])
    terms = [d.decode(i) for i in range(len(d))]
    script = [
        ("sub", "x", goals, caps, ("stale",), tau0, False),
        ("sub", "x#2", renamed, caps, ("stale",), tau0, False),  # joins x's lane group
        ("sub", "c", contained, caps, ("stale",), tau0, False),  # a virtual lane under x's pattern
        ("sub", "t", goals, tiny, ("eager",), tau0, False),
        ("sub", "t#2", goals, tiny, ("eager",), tau0, False),  # joins t's lane group; overflows
        ("cs", EMPTY, rows[0]),
        ("cs", gone, rows[1]),  # burst: the deferred batch grows
        ("flush", ["x"]),  # x moves to a frontier of its own
        ("cs", rows[0][:3], rows[2]),  # burst: x#2's and c's batch grows again
        ("flush",),  # two frontiers through the delta chain
    ]
    return terms, script


CASES = {
    "degraded": (lambda mod: {"max_fire_retries": 0}, paper_script),
    "round_trip": (lambda mod: {"deferred_device_resident": False}, paper_script),
    "matcher": (lambda mod: {"matcher": CountingMatcher(jref if mod is jcore else tref)}, paper_script),
    "decay": (lambda mod: {"decay_patience": 1}, burst_script),
}


def check_option(case):
    """``case`` with the lattice and the delta chain off."""
    options, make_script = CASES[case]
    terms, script = make_script()[:2]
    ref = run_script(jcore, terms, script, options={**LATTICE_OFF, **options(jcore)})
    port_options = options(tcore)
    port = run_script(tcore, terms, script, options={**LATTICE_OFF, **port_options})
    assert_runs_equal(port, ref)
    broker, counters = port[0], port[4]
    if case == "degraded":
        assert counters["degraded_fires"] > 0
        assert any(st.degraded_fires for st in broker.stats)
    elif case == "round_trip":
        # the flush fires two frontiers, one pass each
        assert port[3][-1]["n_evaluated"] == 2
    elif case == "matcher":
        assert port_options["matcher"].calls > 0
    else:
        assert counters["batch_shrinks"] > 0 and counters["batch_grows"] > 0


@pytest.mark.parametrize("case", ["degraded", "decay"])
def test_option_equals_reference(case):
    check_option(case)


@pytest.mark.parametrize("case", ["matcher", "round_trip", "degraded", "decay"])
def test_option_in_the_default_configuration_equals_reference(case):
    options = CASES[case][0]
    terms, script = lattice_script()
    ref = run_script(jcore, terms, script, options=options(jcore))
    port_options = options(tcore)
    port = run_script(tcore, terms, script, options=port_options)
    assert_runs_equal(port, ref)
    broker, stats, counters = port[0], port[3], port[4]
    assert broker.subsume_interests and broker.delta_frontiers
    assert broker.bank.n_virtual == 1 and broker._refine_dev is not None
    assert port[1]["x#2"].canon_sig == port[1]["x"].canon_sig
    # the deferred frontiers' words: the segmented pass over the chain's
    # union, unless the round trip turns the chain off
    seg_keys = [k for k in broker._exec_cache if k[0] == "words-seg"]
    assert stats[-1]["n_evaluated"] == 3 and stats[-1]["fanout_copies"] == 3
    if case == "round_trip":
        assert not seg_keys and not any(k[0] == "cohort-delta" for k in broker._exec_cache)
    else:
        assert seg_keys and stats[-1]["rows_matched"] == stats[-1]["rows_distinct"] > 0
    if case == "matcher":
        assert port_options["matcher"].calls > 0
        assert all(k[-1] == id(port_options["matcher"]) for k in seg_keys)
    elif case == "degraded":
        # the overflowing lane group: one slot, both members degraded
        first = stats[0]
        assert first["degraded_fires"] == 2 and (first["distinct_interests"], first["fanout_copies"]) == (1, 2)
    elif case == "decay":
        assert counters["batch_grows"] >= 2 and counters["batch_shrinks"] == 3
    else:
        assert counters["degraded_fires"] == 0 and counters["batch_shrinks"] == 1
