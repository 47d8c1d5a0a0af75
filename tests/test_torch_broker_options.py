"""repro_torch's Broker against repro's under its non-default options (CPU, exact).

Each case gives both brokers the same constructor argument (beside
``LATTICE_OFF``, the lattice and the delta chain off) and drives them
through one script (``tests/test_torch_broker.py``'s runner); every step's
stores, states, statistics and counters must be equal. This file runs the
first two cases, ``test_torch_broker_hooks.py`` the other two (each case
compiles its own reference steps, so one file would take too long):

* ``max_fire_retries=0``: the tiny-caps subscriber of the paper example
  overflows, so its fire goes through the per-interest fallback
  (``_degraded_eval``) at once;
* ``deferred_device_resident=False``: fired batches go through host arrays
  and the closing flush evaluates one frontier a pass;
* ``matcher``: the bank words come from a custom single-word matcher, so
  cohort steps take the composed words + routing path;
* ``decay_patience=1``: a deferred batch grown by a duplicate-heavy burst
  shrinks at the first under-filled drain.
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


CASES = {
    "degraded": (lambda mod: {"max_fire_retries": 0}, paper_script),
    "round_trip": (lambda mod: {"deferred_device_resident": False}, paper_script),
    "matcher": (lambda mod: {"matcher": CountingMatcher(jref if mod is jcore else tref)}, paper_script),
    "decay": (lambda mod: {"decay_patience": 1}, burst_script),
}


def check_option(case):
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
