"""repro_torch's Broker against repro's (CPU, exact).

The port's ``Broker(d, device="cpu", **options)`` is the reference's
``Broker(d, **options)``. One script of subscribe / changeset / flush /
unsubscribe steps drives both, with the same constructor options; after every
step each subscriber's result (all five output stores, or None when its
policy deferred it), every live subscriber's τ and ρ, and every
``BrokerStats`` field except the two times must be equal. The scripts of this
file, ``_lifecycle``, ``_stream``, ``_options`` and ``_hooks`` hold the
brokers with the lattice and the delta chain off (``LATTICE_OFF``);
``test_torch_broker_default.py`` holds the default configuration.
Scenarios:

* the paper's running example with four subscribers under three policies,
  one overflowing its capacities, ending in a flush that fires two
  frontiers in one stacked pass (a generator stream is in
  ``test_torch_broker_stream.py``);
* ``make_broker_step``; and the state carry into a port broker.

The lifecycle (subscribe midstream, unsubscribe with lane reuse, rebuild
counts, ``share_target``, a bank wider than 32 lanes) is in
``test_torch_broker_lifecycle.py``, a generator stream in
``test_torch_broker_stream.py``; both use this file's script runner.

The port's broker is also held against the port's ``IrapEngine`` on each
subscriber's composed changeset, and ``Broker()`` must target CUDA.
The reference runs once per scenario (module fixtures): its cohort steps
are compiled by XLA, which dominates the cost.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402

A = "rdf:type"
OUT_FIELDS = ("r", "r_i", "r_prime", "a", "a_i")
TIMES = ("elapsed_s", "rejit_s")
EMPTY = np.zeros((0, 3), np.int32)
# the stacked flush without the subsumption lattice (the reference's PR 3-5 broker)
LATTICE_OFF = dict(subsume_interests=False, delta_frontiers=False)


# ---------------------------------------------------------------------------
# one script, both packages
# ---------------------------------------------------------------------------

def policy(mod, spec):
    kind = spec[0]
    if kind == "eager":
        return None
    if kind == "every":
        return mod.PushPolicy.every(spec[1])
    if kind == "priority":
        return mod.PushPolicy.priority_lane()
    if kind == "stale":
        return mod.PushPolicy.max_staleness(1e9)
    raise KeyError(kind)


def store_np(store):
    return np.asarray(store.spo).copy(), int(store.n)


def new_broker(mod, terms, options=None):
    """A broker of ``mod`` over ``terms``; ``options`` are further
    constructor arguments, the same for both packages (none: the defaults)."""
    options = options or {}
    if mod is jcore:
        d = jcore.Dictionary()
        for t in terms:
            d.encode_term(t)
        return jcore.Broker(d, **options)
    return tcore.Broker(tcore.load_dictionary(terms), device="cpu", **options)


def run_script(mod, terms, script, broker=None, options=None):
    """Drive a broker through ``script``; returns (broker, subs, records).

    Steps: ("sub", name, (bgp, ogp), caps dict, policy spec, initial rows or
    None, share_target), ("cs", removed, added), ("flush",) or ("flush",
    names), ("unsub", name). Names that differ only after a "#" share one
    target dataset; a broker's subscribers from before the script are named
    by position.
    """
    broker = new_broker(mod, terms, options) if broker is None else broker
    subs = {}
    records = []
    for step in script:
        op = step[0]
        outs = None
        if op == "sub":
            _, name, (bgp, ogp), caps, pol, init, share = step
            expr = mod.InterestExpr.parse("g", f"t:{name.split('#')[0]}", bgp, ogp)
            subs[name] = broker.subscribe(expr, mod.StepCapacities(**caps), initial_target=init,
                                          policy=policy(mod, pol), share_target=share)
        elif op == "unsub":
            broker.unsubscribe(subs.pop(step[1]))
        elif op == "cs":
            outs = broker.process_changeset(step[1], step[2])
        elif op == "flush":
            outs = broker.flush([subs[n] for n in step[1]] if len(step) > 1 else None)
        else:
            raise KeyError(op)
        order = list(broker.subs)
        names = {id(s): f"pre{k}" for k, s in enumerate(order)}
        names.update({id(s): n for n, s in subs.items()})
        rec = {
            "names": [names[id(s)] for s in order],
            "states": {names[id(s)]: (store_np(s.tau), store_np(s.rho), s.since) for s in order},
            "outs": None,
            "seq": broker._seq,
        }
        if outs is not None:
            rec["outs"] = [
                None if o is None else {f: store_np(getattr(o, f)) for f in OUT_FIELDS}
                for o in outs
            ]
            rec["overflow"] = [None if o is None else bool(o.overflow) for o in outs]
        records.append(rec)
    stats = [{k: v for k, v in dataclasses.asdict(st).items() if k not in TIMES} for st in broker.stats]
    return broker, subs, records, stats, counters(broker)


def counters(broker):
    """The broker's build and volume counters and its bank, as of now."""
    out = {f: getattr(broker, f) for f in ("rejit_count", "words_compiles", "batch_grows", "batch_shrinks",
                                           "rows_matched", "rows_distinct", "degraded_fires")}
    out["cohort_compiles"] = sorted(broker.cohort_compiles.values())
    out["bank"] = broker.bank.patterns_padded().tolist()
    out["n_lanes"] = broker.bank.n_lanes
    return out


def assert_runs_equal(port, ref):
    _, _, p_recs, p_stats, p_counters = port
    _, _, r_recs, r_stats, r_counters = ref
    assert len(p_recs) == len(r_recs)
    for i, (p, r) in enumerate(zip(p_recs, r_recs)):
        assert p["names"] == r["names"], i
        assert p["seq"] == r["seq"], i
        for name, ((pt, ptn), (pr, prn), psince) in p["states"].items():
            (rt, rtn), (rr, rrn), rsince = r["states"][name]
            np.testing.assert_array_equal(pt, rt, err_msg=f"step {i} {name} tau")
            np.testing.assert_array_equal(pr, rr, err_msg=f"step {i} {name} rho")
            assert (ptn, prn, psince) == (rtn, rrn, rsince), (i, name)
        if r["outs"] is None:
            assert p["outs"] is None, i
            continue
        assert p["overflow"] == r["overflow"], i
        for k, (po, ro) in enumerate(zip(p["outs"], r["outs"])):
            assert (po is None) == (ro is None), (i, k)
            if ro is None:
                continue
            for f in OUT_FIELDS:
                np.testing.assert_array_equal(po[f][0], ro[f][0], err_msg=f"step {i} sub {k} {f}")
                assert po[f][1] == ro[f][1], (i, k, f)
    assert p_stats == r_stats
    assert p_counters == r_counters


# ---------------------------------------------------------------------------
# scenario 1: the paper's running example under three policies
# ---------------------------------------------------------------------------

ATHLETE = ([("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?goals")], [("?a", "foaf:homepage", "?page")])
TYPES = ([("?a", A, "dbo:Athlete")], [])
TEAMS = ([("?x", "dbo:team", "?t"), ("?t", A, "dbo:Team")], [])
PAPER_CAPS = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
TINY_CAPS = dict(n_removed=16, n_added=16, tau=4, rho=4, pulls=4)  # overflows: grows alone


def paper_data():
    d = jcore.Dictionary()
    enc = d.encode_triples
    tau0 = enc([
        ("dbr:Marcel", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
        ("dbr:Cristiano_Ronaldo", "foaf:homepage", '"http://cristianoronaldo.com"'),
    ])
    changesets = [
        (enc([("dbr:Marcel", "dbp:goals", "1"), ("dbr:Marcel", "dbo:team", "dbr:FNFT"),
              ("dbr:Tim%02", "foaf:name", '"Tim Berners-Lee"'), ("dbr:Cristiano_Ronaldo", "dbp:goals", "96")]),
         enc([("dbr:Cristiano_Ronaldo", "dbp:goals", "216"), ("dbr:Barack_Obama", "foaf:name", '"Barack Obama"'),
              ("dbr:Barack_Obama", "foaf:homepage", '"http://www.barackobama.com/"'),
              ("dbr:Rio_Ferdinand", A, "foaf:Person"), ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
              ("dbr:Rio_Ferdinand", "dbp:goals", "10"), ("dbr:Arvid_Smit", A, "dbo:Athlete"),
              ("dbr:FNFT", A, "dbo:Team")])),
        (EMPTY, enc([("dbr:Arvid_Smit", "dbp:goals", "3"), ("dbr:X", "dbo:team", "dbr:FNFT")])),
        (enc([("dbr:Rio_Ferdinand", "dbp:goals", "10")]), EMPTY),
    ]
    for bgp, ogp in (ATHLETE, TYPES, TEAMS):
        jcore.compile_interest(jcore.InterestExpr.parse("g", "t", bgp, ogp), d)
    return [d.decode(i) for i in range(len(d))], tau0, changesets


def paper_script():
    terms, tau0, changesets = paper_data()
    script = [
        ("sub", "athlete", ATHLETE, PAPER_CAPS, ("eager",), tau0, False),
        ("sub", "types", TYPES, PAPER_CAPS, ("every", 2), tau0, False),
        ("sub", "teams", TEAMS, PAPER_CAPS, ("stale",), tau0, False),
        ("sub", "athlete#tiny", ATHLETE, TINY_CAPS, ("eager",), tau0, False),
        *(("cs", d, a) for d, a in changesets),
        ("flush",),
    ]
    return terms, script, changesets, tau0


@pytest.fixture(scope="module")
def paper_reference():
    terms, script, _, _ = paper_script()
    return run_script(jcore, terms, script, options=LATTICE_OFF)


def test_paper_example_equals_reference(paper_reference):
    terms, script, _, _ = paper_script()
    port = run_script(tcore, terms, script, options=LATTICE_OFF)
    assert_runs_equal(port, paper_reference)
    # overflow doubled only the tiny subscriber's capacities
    assert port[1]["athlete#tiny"].caps.tau > TINY_CAPS["tau"]
    assert port[1]["athlete"].caps == tcore.StepCapacities(**PAPER_CAPS)
    # the closing flush fired two frontiers (types: changeset 3; teams: 1-3)
    flush = port[3][-1]
    assert flush["n_evaluated"] == 2 and flush["rows_matched"] > flush["rows_distinct"]
    assert any(k[6] == 1 for k in port[0].cohort_compiles)  # per-cohort slots stay dense


def compose(pending, d_np, a_np):
    """Def 6 on host sets: <D1, A1> then <D2, A2> is <D1 ∪ D2, (A1 \\ D2) ∪ A2>."""
    d2 = {tuple(map(int, r)) for r in d_np}
    a2 = {tuple(map(int, r)) for r in a_np}
    if pending is None:
        return d2, a2
    d1, a1 = pending
    return d1 | d2, (a1 - d2) | a2


def as_rows(rows):
    return np.asarray(sorted(rows), np.int32).reshape(-1, 3)


def check_against_engine(terms, script, options=None):
    """Every fire of the port broker (constructor ``options``) equals the
    port IrapEngine applied to the subscriber's composed changeset since its
    last fire."""
    _, _, records, _, _ = run_script(tcore, terms, script, options=options)
    d = tcore.load_dictionary(terms)
    engine = tcore.IrapEngine(d, device="cpu")
    shadow, pending = {}, {}
    fires = 0
    for step, rec in zip(script, records):
        if step[0] == "sub":
            _, name, (bgp, ogp), caps, _, init, _ = step
            shadow[name] = engine.register_interest(
                tcore.InterestExpr.parse("g", f"t:{name}", bgp, ogp), tcore.StepCapacities(**caps),
                initial_target=init)
            pending[name] = None
        elif step[0] == "cs":
            for name in rec["names"]:
                pending[name] = compose(pending[name], step[1], step[2])
        if rec["outs"] is None:
            continue
        for name, out in zip(rec["names"], rec["outs"]):
            if out is None:
                continue
            dd, aa = pending[name]
            pending[name] = None
            want = shadow[name].apply(as_rows(dd), as_rows(aa))
            for f in OUT_FIELDS:
                got = out[f][0][: out[f][1]]
                np.testing.assert_array_equal(got, tcore.to_numpy(getattr(want, f)), err_msg=f"{name} {f}")
            (tau, tau_n), (rho, rho_n), _ = rec["states"][name]
            np.testing.assert_array_equal(tau[:tau_n], tcore.to_numpy(shadow[name].tau))
            np.testing.assert_array_equal(rho[:rho_n], tcore.to_numpy(shadow[name].rho))
            fires += 1
    return fires


def test_paper_example_equals_port_engine():
    terms, script, _, _ = paper_script()
    assert check_against_engine(terms, script, options=LATTICE_OFF) == 3 + 2 + 1 + 3


def test_make_broker_step_equals_reference():
    terms, _, changesets, tau0 = paper_script()
    d_np, a_np = changesets[0]
    caps = [PAPER_CAPS] * 3
    outs = {}
    for mod in (jcore, tcore):
        d = jcore.Dictionary() if mod is jcore else tcore.Dictionary()
        for t in terms:
            d.encode_term(t)
        plans = [mod.compile_interest(mod.InterestExpr.parse("g", "t", b, o), d) for b, o in (ATHLETE, TYPES, TEAMS)]
        bank = mod.build_pattern_bank(plans)
        sc = [mod.StepCapacities(**c) for c in caps]
        id_caps = [d.id_capacity * c.id_headroom for c in sc]
        kw = {} if mod is jcore else {"device": "cpu"}
        step = mod.make_broker_step(bank, plans, sc, id_caps, **kw)

        def store(rows, cap):
            return jcore.from_numpy(rows, cap) if mod is jcore else tcore.from_numpy(rows, cap, "cpu")

        taus = tuple(store(tau0, c.tau) for c in sc)
        rhos = tuple(store(EMPTY, c.rho) for c in sc)
        tau1, rho1, out = step(store(d_np, 16), store(a_np, 16), taus, rhos)
        outs[mod.__name__] = [store_np(t) for t in tau1] + [store_np(r) for r in rho1] + [
            store_np(getattr(o, f)) for o in out for f in OUT_FIELDS]
    assert len(outs["repro_torch.core"]) == 3 * 7
    for (gs, gn), (ws, wn) in zip(outs["repro_torch.core"], outs["repro.core"]):
        np.testing.assert_array_equal(gs, ws)
        assert gn == wn


# ---------------------------------------------------------------------------
# state carry, device default
# ---------------------------------------------------------------------------

def test_state_carry_continues_bit_identically(paper_reference):
    """A reference broker runs the paper stream and flushes; its dictionary,
    bank, subscribers and clock move into a port broker, and both continue
    through more changesets (with a subscribe) to the same stores."""
    terms, script, changesets, tau0 = paper_script()
    r_broker = paper_reference[0]
    bank = r_broker.bank
    states = [
        tcore.state.SubscriberState(
            expr=tcore.InterestExpr.parse(s.expr.source, s.expr.target,
                                          [p.slots() for p in s.expr.bgp], [p.slots() for p in s.expr.ogp]),
            caps=tcore.StepCapacities(**dataclasses.asdict(s.caps)),
            policy=tcore.PushPolicy(**dataclasses.asdict(s.policy)),
            tau=store_np(s.tau), rho=store_np(s.rho), lanes=s.lanes, since=s.since,
        )
        for s in r_broker.subs
    ]
    port = tcore.carry_broker(terms, bank._rows, bank._refs, bank._free, states,
                              seq=r_broker._seq, last_cid=r_broker._last_cid, device="cpu", **LATTICE_OFF)
    more = [("cs", *changesets[1]), ("sub", "late", TYPES, PAPER_CAPS, ("eager",), tau0, False),
            ("cs", *changesets[0]), ("cs", *changesets[2]), ("flush",)]
    # carry the reference broker itself on, and the port broker beside it
    ref_more = run_script(jcore, terms, more, broker=r_broker)
    port_more = run_script(tcore, terms, more, broker=port)
    p_recs, r_recs = port_more[2], ref_more[2]
    for p, r in zip(p_recs, r_recs):
        assert p["seq"] == r["seq"]
        if r["outs"] is not None:
            for po, ro in zip(p["outs"], r["outs"]):
                assert (po is None) == (ro is None)
                if ro is not None:
                    for f in OUT_FIELDS:
                        np.testing.assert_array_equal(po[f][0], ro[f][0])
    for ps, rs in zip(port.subs, r_broker.subs):
        np.testing.assert_array_equal(ps.tau.spo.numpy(), np.asarray(rs.tau.spo))
        np.testing.assert_array_equal(ps.rho.spo.numpy(), np.asarray(rs.rho.spo))
        assert ps.lanes == rs.lanes and ps.since == rs.since
    assert port_more[3][-3:] == ref_more[3][-3:]


def test_state_carry_refuses_pending_changesets_and_wrong_lanes():
    terms, _, changesets, tau0 = paper_script()
    broker = tcore.Broker(tcore.load_dictionary(terms), device="cpu", **LATTICE_OFF)
    s = broker.subscribe(tcore.InterestExpr.parse("g", "t", *ATHLETE), tcore.StepCapacities(**PAPER_CAPS),
                         initial_target=tau0, policy=tcore.PushPolicy.every(2))
    broker.process_changeset(*changesets[0])  # pending: deferred by every(2)
    bank = broker.bank
    state = tcore.state.SubscriberState(
        expr=s.expr, caps=s.caps, policy=s.policy, tau=store_np(s.tau), rho=store_np(s.rho),
        lanes=s.lanes, since=s.since)
    with pytest.raises(ValueError, match="pending"):
        tcore.carry_broker(terms, bank._rows, bank._refs, bank._free, [state], seq=broker._seq,
                           last_cid=broker._last_cid, device="cpu", **LATTICE_OFF)
    broker.flush()
    good = dataclasses.replace(state, since=s.since, tau=store_np(s.tau), rho=store_np(s.rho))
    carried = tcore.carry_broker(terms, bank._rows, bank._refs, bank._free, [good], seq=broker._seq,
                                 last_cid=broker._last_cid, device="cpu", **LATTICE_OFF)
    assert carried.subs[0].lanes == s.lanes
    bad = dataclasses.replace(good, lanes=tuple(reversed(s.lanes)))
    with pytest.raises(ValueError, match="lanes"):
        tcore.carry_broker(terms, bank._rows, bank._refs, bank._free, [bad], seq=broker._seq,
                           last_cid=broker._last_cid, device="cpu", **LATTICE_OFF)


def test_state_carry_of_the_default_broker_refuses_pending_changesets_and_wrong_lanes():
    """The same refusals with the lattice on: the bank is a SubsumptionBank,
    whose real lanes, virtual lanes and lane-group signatures are carried."""
    terms, _, changesets, tau0 = paper_script()
    broker = tcore.Broker(tcore.load_dictionary(terms), device="cpu")
    s = broker.subscribe(tcore.InterestExpr.parse("g", "t", *ATHLETE), tcore.StepCapacities(**PAPER_CAPS),
                         initial_target=tau0, policy=tcore.PushPolicy.every(2))
    broker.process_changeset(*changesets[0])  # pending: deferred by every(2)
    bank = broker.bank
    state = tcore.state.SubscriberState(
        expr=s.expr, caps=s.caps, policy=s.policy, tau=store_np(s.tau), rho=store_np(s.rho),
        lanes=s.lanes, since=s.since, canon_sig=s.canon_sig)

    def carry(states):
        return tcore.carry_broker(terms, bank.bank._rows, bank.bank._refs, bank.bank._free, states,
                                  seq=broker._seq, last_cid=broker._last_cid, device="cpu",
                                  virtual_rows=bank._vrows, virtual_refs=bank._vrefs,
                                  virtual_free=bank._vfree, share_roots=[0])

    with pytest.raises(ValueError, match="pending"):
        carry([state])
    broker.flush()
    good = dataclasses.replace(state, since=s.since, tau=store_np(s.tau), rho=store_np(s.rho))
    carried = carry([good])
    assert carried.subs[0].lanes == s.lanes and carried.subs[0].canon_sig == s.canon_sig
    assert carried._share_index == {s.canon_sig: carried.subs[0]}
    with pytest.raises(ValueError, match="lanes"):
        carry([dataclasses.replace(good, lanes=tuple(reversed(s.lanes)))])
    with pytest.raises(ValueError, match="signature"):
        carry([dataclasses.replace(good, canon_sig=None)])


def test_broker_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tcore.Broker().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.Broker()
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.make_broker_step(tcore.build_pattern_bank([]), [], [], [])
    assert tcore.Broker(device="cpu").device.type == "cpu"
