"""repro_torch's Broker on a device mesh against repro's single-device Broker (CPU, exact).

The port's mesh is logical CPU shards of one process (``DeviceMesh.on_cpu``):
placed brokers run each cohort on one mesh device, sharded brokers
(``shard_cohorts=True``) spread every cohort pass over the whole mesh, one
thread a shard. They are held to the reference's **single-device**
``Broker``, which the port's single-device broker already equals; the
reference's own sharded broker is not the yardstick.

* One script with churn (a midstream subscribe, an unsubscribe, a lane
  group, a contained interest on a virtual lane), changesets, a partial
  flush and a closing flush that fires several frontiers, on the data of
  ``tests/test_broker_deferred.py``, through ``tests/test_torch_broker.py``'s
  runner. It runs on the port single-device, placed over 4 shards
  (round robin, load-balanced, pinned) and sharded over 2, 3 and 4 shards,
  in the default configuration and with ``LATTICE_OFF``; every step's
  outputs, τ, ρ and ``BrokerStats`` (times apart) equal the reference's
  single-device run of the same configuration, run once for the module.
* The dedup rejection; the τ-partition cache partitions again only a
  replica whose τ changed; a journaled sharded broker recovers equal to the
  single-device recovery, and both go on equal.
* The data of the reference's ``GOLDEN_SCRIPT`` (``tests/test_broker_sharded.py``)
  through the port's sharded and placed brokers over 8 shards, against the
  reference's single-device broker.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import broker as tbroker  # noqa: E402
from repro_torch.core.distributed import CohortPlacement, DeviceMesh  # noqa: E402
from repro_torch.testing import assert_state_equal, broker_state  # noqa: E402
from test_broker_deferred import CAPS as J_CAPS, _exprs, _stream, _universe  # noqa: E402
from test_torch_broker import A, LATTICE_OFF, assert_runs_equal, run_script  # noqa: E402

CONFIGS = {"default": {}, "lattice_off": LATTICE_OFF}
# test_broker_deferred's capacities, widened so that no fire overflows
CAPS = dict(dataclasses.asdict(J_CAPS), n_removed=64, n_added=64, tau=128, rho=128, pulls=64)
KINDS = ["single", "placed/round_robin", "placed/load_balanced", "placed/pinned", "sharded/2", "sharded/3",
         "sharded/4"]


def mesh_options(kind: str) -> dict:
    if kind == "single":
        return {}
    mode, arg = kind.split("/")
    if mode == "placed":
        return dict(mesh=DeviceMesh.on_cpu(4), placement=CohortPlacement(mode=arg, default=3))
    return dict(mesh=DeviceMesh.on_cpu(int(arg)), shard_cohorts=True)


def exprs():
    """``test_broker_deferred``'s first two interests (one shape cohort) as
    (bgp, ogp), and one contained by the first's goals pattern (a virtual
    lane with the lattice on)."""
    out = [([p.slots() for p in e.bgp], [p.slots() for p in e.ogp]) for e in _exprs()[:2]]
    return out + [([("e:1", "p:goals", "?v")], [])]


def terms_of(d, extra_exprs=()):
    for bgp, ogp in extra_exprs:
        jcore.compile_interest(jcore.InterestExpr.parse("g", "t", bgp, ogp), d)
    return [d.decode(i) for i in range(len(d))]


def churn_script():
    d, tau0 = _universe()
    cs = _stream(d, 4, seed=4)
    ex = exprs()
    terms = terms_of(d, ex)

    def sub(name, e, pol, share=False):
        return ("sub", name, ex[e], CAPS, pol, tau0, share)

    return terms, [
        sub("goals", 0, ("every", 2)),
        sub("goals#2", 0, ("every", 2)),  # a lane group with "goals" when the lattice is on
        sub("e1", 2, ("stale",)),  # contained by a pattern of "goals": a virtual lane
        ("cs", *cs[0]),  # nothing fires
        sub("teams", 1, ("eager",)),
        sub("goals#late", 0, ("stale",), share=True),  # adopts the replica and frontier of "goals"
        ("cs", *cs[1]),  # two frontiers fire
        ("unsub", "goals"),  # the lane group's root leaves
        ("cs", *cs[2]),
        ("cs", *cs[3]),  # two frontiers fire
        ("flush",),  # two frontiers
    ]


def assert_equal_to_single_device(port, ref, kind):
    """Records and statistics as ``assert_runs_equal``; the build counters
    too, save that a sharded broker builds no shared words pass (its step
    computes the words, block-split)."""
    p_counters, r_counters = dict(port[4]), dict(ref[4])
    if kind.startswith("sharded"):
        assert p_counters.pop("words_compiles") == 0
        assert p_counters.pop("rejit_count") == r_counters.pop("rejit_count") - r_counters.pop("words_compiles")
    assert_runs_equal(port[:4] + (p_counters,), ref[:4] + (r_counters,))


@pytest.fixture(scope="module")
def reference_runs():
    terms, script = churn_script()
    return {name: run_script(jcore, terms, script, options=dict(opts)) for name, opts in CONFIGS.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_mesh_broker_equals_reference_single_device(reference_runs, config, kind):
    terms, script = churn_script()
    port = run_script(tcore, terms, script, options=dict(CONFIGS[config], **mesh_options(kind)))
    assert_equal_to_single_device(port, reference_runs[config], kind)
    broker, stats = port[0], port[3]
    passes = sum(st["n_cohort_passes"] for st in stats)
    if kind.startswith("sharded"):
        n = int(kind.split("/")[1])
        assert broker.device_passes == {i: passes for i in range(n)}
        assert any(k[0] == "cohort-sh-delta" for k in broker._exec_cache) == (config == "default")
    elif kind == "placed/pinned":
        assert broker.device_passes == {3: passes}
    elif kind.startswith("placed"):
        assert sum(broker.device_passes.values()) == passes and len(broker.device_passes) > 1
    else:
        assert broker.device_passes == {0: passes}
    assert sum(st["fanout_copies"] - st["distinct_interests"] for st in stats) > 0 or config == "lattice_off"


def test_sharded_rejects_candidate_dedup():
    caps = dict(CAPS, dedup_candidates=8)
    expr = exprs()[0]
    with pytest.raises(ValueError, match="dedup_candidates == 0"):
        jcore.Broker(jcore.Dictionary(), shard_cohorts=True).subscribe(
            jcore.InterestExpr.parse("g", "t", *expr), jcore.StepCapacities(**caps))
    broker = tcore.Broker(tcore.Dictionary(), mesh=DeviceMesh.on_cpu(2), shard_cohorts=True)
    with pytest.raises(ValueError, match="dedup_candidates == 0"):
        broker.subscribe(tcore.InterestExpr.parse("g", "t", *expr), tcore.StepCapacities(**caps))
    assert broker.subs == [] and broker._seq == 0
    plan = tcore.compile_interest(tcore.InterestExpr.parse("g", "t", *expr), tcore.Dictionary())
    with pytest.raises(ValueError, match="dedup_candidates == 0"):
        tcore.make_sharded_cohort_step(plan, tcore.StepCapacities(**caps), 64, DeviceMesh.on_cpu(2))
    with pytest.raises(ValueError, match="differ in type"):
        tcore.Broker(tcore.Dictionary(), mesh=DeviceMesh.on_cpu(2), device="meta")


def test_tau_partitions_follow_tau_versions(monkeypatch):
    """A fire that leaves a replica's τ alone keeps its partitions; only
    the replica whose τ changed is partitioned again."""
    d, tau0 = _universe()
    noise, noise2, goal = (d.encode_triples([t]) for t in
                           (("e:5", "p:noise", "o1"), ("e:5", "p:noise", "o2"), ("e:1", "p:goals", "3")))
    td = tcore.load_dictionary([d.decode(i) for i in range(len(d))])
    calls = []
    real = tbroker.shard_target_store

    def counting(tau, n_shards, cap):
        calls.append(tbroker.to_numpy(tau).tolist())
        return real(tau, n_shards, cap)

    monkeypatch.setattr(tbroker, "shard_target_store", counting)
    broker = tcore.Broker(td, mesh=DeviceMesh.on_cpu(3), shard_cohorts=True)
    ex = exprs()
    goals, teams = (broker.subscribe(tcore.InterestExpr.parse("g", f"t{i}", *ex[i]), tcore.StepCapacities(**CAPS),
                                     initial_target=tau0) for i in (0, 1))
    empty = np.zeros((0, 3), np.int32)
    broker.process_changeset(empty, noise)  # both partitioned; neither τ changes
    versions = (goals.tau_version, teams.tau_version)
    broker.process_changeset(empty, noise2)  # both from the cache
    assert len(calls) == 2 and (goals.tau_version, teams.tau_version) == versions
    broker.process_changeset(empty, goal)  # the goals replica changes
    assert (goals.tau_version, teams.tau_version) == (versions[0] + 1, versions[1])
    broker.process_changeset(empty, noise)
    assert len(calls) == 3 and calls[2] == tbroker.to_numpy(goals.tau).tolist()
    assert len(broker._tau_parts_cache) == 2  # the superseded version left the cache


def test_journaled_sharded_broker_recovers_as_single_device(tmp_path):
    terms, script = churn_script()
    config = CONFIGS["default"]
    cut = script.index(("unsub", "goals")) + 2  # through changeset 2
    journal = tcore.ChangesetJournal(tmp_path / "wal", fsync=False)
    broker = tcore.Broker(tcore.load_dictionary(terms), device="cpu", journal=journal, mesh=DeviceMesh.on_cpu(3),
                          shard_cohorts=True, **config)
    run_script(tcore, terms, script[:cut], broker=broker)
    crashed = broker_state(broker)
    journal.close()
    recovered = {}
    for name, mesh_kw in (("single", {}), ("sharded", dict(mesh=DeviceMesh.on_cpu(3), shard_cohorts=True))):
        j = tcore.ChangesetJournal(tmp_path / "wal", fsync=False)
        recovered[name] = tcore.Broker.recover(j, dictionary=tcore.load_dictionary(terms), device="cpu",
                                               **config, **mesh_kw)
        assert_state_equal(broker_state(recovered[name]), crashed)
    assert recovered["sharded"].device_passes and not recovered["single"].mesh
    rest = [step for step in script[cut:] if step[0] == "cs"][:2] + [("flush",)]
    outs = {}
    for name, b in recovered.items():
        b.journal = None
        outs[name] = [b.process_changeset(*step[1:]) if step[0] == "cs" else b.flush() for step in rest]
    for per_s, per_h in zip(outs["single"], outs["sharded"]):
        assert len(per_s) == len(per_h)
        for o_s, o_h in zip(per_s, per_h):
            assert (o_s is None) == (o_h is None)
            if o_s is not None:
                for f in ("r", "r_i", "r_prime", "a", "a_i"):
                    assert torch.equal(getattr(o_s, f).spo, getattr(o_h, f).spo), f
    assert_state_equal(broker_state(recovered["sharded"]), broker_state(recovered["single"]))


# ---------------------------------------------------------------------------
# the data of the reference's sharded golden
# ---------------------------------------------------------------------------

GOLDEN_CAPS = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
GOLDEN_EXPRS = [
    ([("?a", A, "c:Athlete"), ("?a", "p:goals", "?v")], []),
    ([("?a", A, "c:Team"), ("?a", "p:rank", "?v")], []),
    ([("?a", "p:goals", "?v")], []),
    ([("?a", A, "c:Athlete"), ("?a", "p:plays", "?t"), ("?t", "p:rank", "?r")], [("?a", "p:page", "?w")]),
]


def golden_script():
    """``GOLDEN_SCRIPT``'s dictionary order, τ0, 8-changeset stream
    (seed 3) and churn, as a script of this file's runner."""
    d = jcore.Dictionary()
    tau0 = d.encode_triples([
        ("e:1", A, "c:Athlete"), ("e:1", "p:goals", "10"),
        ("e:2", A, "c:Team"), ("e:2", "p:rank", "1"),
        ("e:3", "p:plays", "e:2"),
    ])
    rng = np.random.default_rng(3)

    def rows(k):
        out = set()
        for _ in range(k):
            e = f"e:{rng.integers(0, 12)}"
            kind = rng.integers(0, 6)
            if kind == 0:
                out.add((e, A, f"c:{['Athlete', 'Team'][rng.integers(2)]}"))
            elif kind == 1:
                out.add((e, "p:goals", str(int(rng.integers(0, 30)))))
            elif kind == 2:
                out.add((e, "p:rank", str(int(rng.integers(0, 5)))))
            elif kind == 3:
                out.add((e, "p:plays", f"e:{rng.integers(0, 12)}"))
            elif kind == 4:
                out.add((e, "p:page", f"w{rng.integers(0, 4)}"))
            else:
                out.add((e, "p:noise", f"o{rng.integers(0, 6)}"))
        return d.encode_triples(sorted(out))

    stream = [(rows(int(rng.integers(0, 5))), rows(int(rng.integers(1, 8)))) for _ in range(8)]
    terms = terms_of(d, GOLDEN_EXPRS)

    def sub(name, e, pol, share=False):
        return ("sub", name, GOLDEN_EXPRS[e], GOLDEN_CAPS, pol, tau0, share)

    script = [sub("A", 0, ("eager",)), sub("B", 1, ("every", 2)), sub("A#C", 0, ("eager",), share=True)]
    for i, cs in enumerate(stream):
        if i == 3:
            script += [sub("D", 3, ("eager",)), ("unsub", "B")]
        script.append(("cs", *cs))
    return terms, script + [("flush",)]


def test_golden_data_on_the_port_mesh_equals_reference_single_device():
    terms, script = golden_script()
    ref = run_script(jcore, terms, script)
    for kind, options in (("sharded/4", dict(mesh=DeviceMesh.on_cpu(4), shard_cohorts=True)),
                          ("placed/8", dict(mesh=DeviceMesh.on_cpu(8),
                                            placement=CohortPlacement(mode="load_balanced")))):
        port = run_script(tcore, terms, script, options=options)
        assert_equal_to_single_device(port, ref, kind)
        placed = {k for k, v in port[0].device_passes.items() if v}
        assert len(placed) == 4 if kind.startswith("sharded") else len(placed) > 1
