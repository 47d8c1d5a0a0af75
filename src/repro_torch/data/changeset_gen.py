"""Synthetic DBpedia-Live-like evolving dataset + changeset stream.

Mirrors the paper's evaluation setting (§4): a large mixed-domain dump with
entity classes (athletes, locations, other people/things), typed attribute
predicates, and a stream of per-day changesets whose adds/removes touch a
configurable fraction of interest-relevant entities — sized so the Football
interest sees ~0.3% and the Location interest a few % of triples, matching
the paper's observed selectivities.

A copy of ``repro.data.changeset_gen`` over the port's own dictionary: the
same seed yields the same id arrays in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..core.dictionary import Dictionary

# vocabulary of predicates / classes (prefix-style, as in the paper)
P_TYPE = "rdf:type"
P_GOALS = "dbp:goals"
P_NAME = "foaf:name"
P_TEAM = "dbo:team"
P_LABEL = "rdfs:label"
P_LAT = "wgs:lat"
P_LONG = "wgs:long"
P_ABSTRACT = "dbo:abstract"
P_SUBJECT = "dcterms:subject"
P_HOMEPAGE = "foaf:homepage"
C_ATHLETE = "dbo:SoccerPlayer"
C_PLACE = "dbo:Place"
C_PERSON = "foaf:Person"
C_WORK = "dbo:Work"


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    n_athletes: int = 400
    n_places: int = 800
    n_other: int = 4000
    n_teams: int = 60
    seed: int = 0
    # per-changeset activity
    adds_per_changeset: int = 600
    removes_per_changeset: int = 300
    athlete_fraction: float = 0.02  # fraction of changeset rows touching athletes
    place_fraction: float = 0.06


class DBpediaLikeGenerator:
    """Seeds an initial dump, then yields ⟨removed, added⟩ changesets."""

    def __init__(self, cfg: GeneratorConfig, dictionary: Dictionary | None = None):
        self.cfg = cfg
        self.dict = dictionary if dictionary is not None else Dictionary()
        self.rng = np.random.default_rng(cfg.seed)
        self._athletes = [f"dbr:Athlete_{i}" for i in range(cfg.n_athletes)]
        self._places = [f"dbr:Place_{i}" for i in range(cfg.n_places)]
        self._others = [f"dbr:Thing_{i}" for i in range(cfg.n_other)]
        self._teams = [f"dbr:Team_{i}" for i in range(cfg.n_teams)]
        self._next_id = 0
        self.current: set = set()  # live triples (string form)

    # ------------------------------------------------------------------
    def _team_triples(self, team: str) -> List[Tuple[str, str, str]]:
        return [(team, P_LABEL, f'"{team} FC"')]

    def _athlete_triples(self, a: str, full: bool) -> List[Tuple[str, str, str]]:
        rows = [(a, P_TYPE, C_ATHLETE), (a, P_NAME, f'"{a}"')]
        team = self._teams[self.rng.integers(len(self._teams))]
        rows.append((a, P_TEAM, team))
        rows += self._team_triples(team)
        if full or self.rng.random() < 0.7:
            rows.append((a, P_GOALS, str(int(self.rng.integers(0, 300)))))
        if self.rng.random() < 0.3:
            rows.append((a, P_HOMEPAGE, f'"http://{a}.example.org"'))
        return rows

    def _place_triples(self, p: str, full: bool) -> List[Tuple[str, str, str]]:
        rows = [
            (p, P_TYPE, C_PLACE),
            (p, P_LABEL, f'"{p}"'),
            (p, P_LAT, f"{self.rng.random() * 180 - 90:.4f}"),
            (p, P_LONG, f"{self.rng.random() * 360 - 180:.4f}"),
        ]
        if full or self.rng.random() < 0.8:
            rows.append((p, P_ABSTRACT, f'"Abstract of {p}"'))
        if self.rng.random() < 0.5:
            rows.append((p, P_SUBJECT, f"dbc:Category_{int(self.rng.integers(40))}"))
        return rows

    def _other_triples(self, o: str) -> List[Tuple[str, str, str]]:
        cls = C_PERSON if self.rng.random() < 0.5 else C_WORK
        rows = [(o, P_TYPE, cls), (o, P_NAME, f'"{o}"')]
        for j in range(int(self.rng.integers(1, 5))):
            rows.append((o, f"dbp:prop{j}", str(int(self.rng.integers(1000)))))
        return rows

    # ------------------------------------------------------------------
    def initial_dump(self) -> np.ndarray:
        rows: List[Tuple[str, str, str]] = []
        for a in self._athletes:
            rows += self._athlete_triples(a, full=True)
        for p in self._places:
            rows += self._place_triples(p, full=True)
        for o in self._others:
            rows += self._other_triples(o)
        self.current = set(rows)
        return self.dict.encode_triples(sorted(self.current))

    def slice_for(self, predicate_filter) -> np.ndarray:
        """Initial RDFSlice-style subset (paper §2): triples passing a filter."""
        rows = sorted(t for t in self.current if predicate_filter(t))
        return self.dict.encode_triples(rows)

    # ------------------------------------------------------------------
    def changeset(self) -> Tuple[np.ndarray, np.ndarray]:
        """One ⟨removed, added⟩ changeset (dictionary-encoded)."""
        cfg, rng = self.cfg, self.rng
        adds: List[Tuple[str, str, str]] = []
        removes: List[Tuple[str, str, str]] = []

        # sort before sampling: ``self.current`` is a Python set, and set
        # iteration order varies with PYTHONHASHSEED across processes —
        # sorting makes every stream a pure function of ``cfg.seed``, so
        # benchmarks and examples reproduce run-to-run
        live = sorted(self.current)
        # removals: random live triples + occasional whole-entity retirement
        if live:
            k = min(cfg.removes_per_changeset, len(live))
            idx = rng.choice(len(live), size=k, replace=False)
            removes += [live[i] for i in idx]

        # adds: entity churn weighted by domain fractions
        n = cfg.adds_per_changeset
        n_ath = int(n * cfg.athlete_fraction)
        n_pl = int(n * cfg.place_fraction)
        for _ in range(max(1, n_ath // 4)):
            a = f"dbr:NewAthlete_{self._next_id}"
            self._next_id += 1
            full = rng.random() < 0.5  # half arrive with partial attribute sets
            adds += self._athlete_triples(a, full=full)
        for _ in range(max(1, n_pl // 5)):
            p = f"dbr:NewPlace_{self._next_id}"
            self._next_id += 1
            adds += self._place_triples(p, full=rng.random() < 0.5)
        # goal updates for existing athletes (remove+add pattern)
        for _ in range(max(1, n_ath // 2)):
            a = self._athletes[rng.integers(len(self._athletes))]
            old = sorted(
                t for t in self.current if t[0] == a and t[1] == P_GOALS
            )
            removes += old
            adds.append((a, P_GOALS, str(int(rng.integers(0, 300)))))
        # bulk uninteresting churn
        while len(adds) < n:
            o = f"dbr:NewThing_{self._next_id}"
            self._next_id += 1
            adds += self._other_triples(o)

        removes = [t for t in sorted(set(removes)) if t in self.current]
        adds = sorted(set(adds) - set(removes))
        self.current -= set(removes)
        self.current |= set(adds)
        return (
            self.dict.encode_triples(sorted(removes)),
            self.dict.encode_triples(adds),
        )

    def stream(self, n: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(n):
            yield self.changeset()
