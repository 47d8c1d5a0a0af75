"""Distributed interest evaluation on a single-controller device mesh (port of
``repro.core.distributed``).

The paper's §6 names a distributed pub/sub architecture as future work; the
reference builds both halves of it on ``shard_map``, where ONE Python
process drives every device of a 1-D mesh. This module keeps that shape:

* a :class:`DeviceMesh` is an ordered list of devices inside this process
  plus an axis name. :meth:`DeviceMesh.on_card` lays ``n`` shards round
  robin over the CUDA cards (on one card, ``n`` logical shards of
  ``cuda:0``, as XLA's forced host devices are logical shards of one CPU);
  a CPU mesh exists only when the caller asks for it (:meth:`DeviceMesh.on_cpu`);
* :func:`run_spmd` runs one body per shard, each on its own thread, and the
  collectives (:func:`all_to_all`, :func:`all_gather`, :func:`or_reduce`)
  meet in slot lists indexed by the shard: each shard deposits its part and
  reads the others' once all have deposited, taking turns in shard order,
  so results depend on shard order only, never on thread timing. There is
  no process group and no spawned process. Threads, not a per-shard loop,
  because the collectives sit inside the evaluator's hooks (``probe_impl``,
  ``table_reduce``), deep in the per-member evaluation that the broker's
  cohort step runs.

**Within one evaluation pass** (the shard_map semijoin dataflow of the
reference, used by :func:`make_distributed_evaluator` and the broker's
sharded cohort step, :func:`repro_torch.core.broker.make_sharded_cohort_step`):

* the target dataset is hash-partitioned twice, the SPO index by subject and
  the OPS index by object, so every bound-slot probe has exactly one owner
  shard;
* probes whose binding lives on another shard are routed with
  :func:`all_to_all_ragged` (each owner gets this shard's live queries for
  it) and answered by the owner (:func:`make_routed_probe`,
  :func:`make_routed_probe_batched`). The partition key is the probe's
  bound slot, so the owner holds the whole prefix range and even the
  ``fanout`` truncation order is that of the unpartitioned index;
* signature tables and edge vectors are OR-reduced across the shards
  (:func:`make_or_reduce`): boolean tables directly, int32 lane-bit words
  through :func:`all_gather` and a bitwise-OR fold.

**Across cohorts**, :class:`CohortPlacement` maps whole cohorts onto mesh
devices (round robin, load-balanced by padded member count, or pinned).

Host-side partitioning (:func:`partition_rows`, :func:`prepare_target_shards`)
reports per-shard overflow through flags instead of raising;
:func:`shard_target_store` is the same partition of a store on its device.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .evaluation import SideResult, TripleIndex, make_side_evaluator, probe, probe_dyn
from .interest import CompiledInterest
from .triples import PAD, TripleStore, lex_sort


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: an ordered tuple of devices of this process and an axis name.

    Several shards may name one device (logical shards of one card or of the
    CPU).
    """

    devices: Tuple[torch.device, ...]
    axis_name: str = "shard"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh holds at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def on_card(cls, n_shards: int) -> "DeviceMesh":
        """``n_shards`` shards laid round robin over the CUDA cards; raises
        without a card."""
        if not torch.cuda.is_available():
            raise RuntimeError("DeviceMesh.on_card needs a CUDA device and none is available")
        count = torch.cuda.device_count()
        return cls(tuple(torch.device("cuda", i % count) for i in range(n_shards)))

    @classmethod
    def on_cpu(cls, n_shards: int) -> "DeviceMesh":
        """``n_shards`` logical shards of the CPU (the plain kernel versions)."""
        return cls((torch.device("cpu"),) * n_shards)

    @property
    def size(self) -> int:
        return len(self.devices)


# ---------------------------------------------------------------------------
# one thread per shard, collectives at a barrier
# ---------------------------------------------------------------------------

# bytes deposited into each kind of collective, summed over shards, and the
# number of collectives; read and reset by callers (chip_smoke.py)
traffic: Dict[str, int] = {"all_to_all": 0, "all_gather": 0, "or_reduce": 0, "collectives": 0}

# how long a shard waits at a collective for the others before the whole
# run_spmd call fails
COLLECTIVE_TIMEOUT_S = 600.0


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


class _Group:
    """The shared state of one :func:`run_spmd` call.

    The shards take turns: one runs at a time, in shard order, from one
    collective to the next, and hands the turn on when it has deposited its
    part. Running them one at a time costs nothing that Python's interpreter
    lock would not take anyway (the shards' host code holds it), and it
    spares them contending for that lock at every tensor operation. The
    last shard to deposit checks that every shard called the same collective
    and folds the OR reductions once. A shard that deposits while another
    has returned, or that wakes to a collective nobody completed, breaks the
    group: the shards called different collectives. Slots alternate between
    two lists: a shard deposits generation g + 2 only after every shard has
    read generation g.
    """

    def __init__(self, mesh: DeviceMesh):
        n = mesh.size
        self.n = n
        self.cond = threading.Condition()
        self.turn = 0
        self.done = [False] * n
        self.broken = False
        self.completed = -1  # the last generation folded
        self.slots: Tuple[List, List] = ([None] * n, [None] * n)
        self.tags: Tuple[List, List] = ([None] * n, [None] * n)
        self.folded: List[Optional[torch.Tensor]] = [None, None]

    # all of the below run with self.cond held
    def _break(self, err: BaseException) -> BaseException:
        self.broken = True
        self.cond.notify_all()
        return err

    def _wait_turn(self, my: int) -> None:
        if not self.cond.wait_for(lambda: self.turn == my or self.broken, timeout=COLLECTIVE_TIMEOUT_S):
            raise self._break(TimeoutError(f"shard {my} waited {COLLECTIVE_TIMEOUT_S} s for its turn"))
        if self.broken:
            raise threading.BrokenBarrierError

    def _pass_turn(self, my: int) -> None:
        for step in range(1, self.n + 1):
            k = (my + step) % self.n
            if not self.done[k]:
                self.turn = k
                break
        self.cond.notify_all()

    def _fold(self, gen: int) -> None:
        g = gen % 2
        tags = self.tags[g]
        if any(t is None or t[0] != gen for t in tags) or len({t[1:] for t in tags}) != 1:
            raise self._break(RuntimeError(f"shards called different collectives: {tags}"))
        kind = tags[0][1]
        bufs = self.slots[g]
        traffic[kind] += sum(x.numel() * x.element_size() for b in bufs for x in (b if isinstance(b, list) else [b]))
        traffic["collectives"] += 1
        if kind == "or_reduce":
            acc = bufs[0].clone()
            for b in bufs[1:]:
                acc |= b.to(acc.device)
            self.folded[g] = acc
        self.completed = gen

    def start(self, my: int) -> None:
        with self.cond:
            self._wait_turn(my)

    def finish(self, my: int) -> None:
        with self.cond:
            self.done[my] = True
            self._pass_turn(my)

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()

    def deposit(self, my: int, gen: int, kind: str, x) -> None:
        """Deposit this shard's part of collective ``gen`` (a tensor, or a
        list of one tensor per shard for a ragged exchange), hand the turn
        on, and return when the collective is complete and it is this
        shard's turn again."""
        with self.cond:
            if any(self.done):
                raise self._break(RuntimeError(f"shards called different collectives: shard {my} called {kind} "
                                               f"#{gen} after shards {[k for k in range(self.n) if self.done[k]]} "
                                               "returned"))
            g = gen % 2
            self.slots[g][my] = x
            shape = (len(x), x[0].dtype) if isinstance(x, list) else (tuple(x.shape), x.dtype)
            self.tags[g][my] = (gen, kind, *shape)
            if my == self.n - 1:
                self._fold(gen)
            self._pass_turn(my)
            self._wait_turn(my)
            if self.completed != gen:
                raise self._break(RuntimeError(f"shards called different collectives: shard {my}'s {kind} "
                                               f"#{gen} was left incomplete"))


@dataclasses.dataclass
class _ShardContext:
    mesh: DeviceMesh
    my: int
    group: _Group
    gen: int = 0

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.my]

    def exchange(self, kind: str, x: torch.Tensor) -> int:
        """Deposit ``x``, wait for the others; returns the slot list to read."""
        self.group.deposit(self.my, self.gen, kind, x)
        self.gen += 1
        return (self.gen - 1) % 2


_local = threading.local()


def _context(axis: str) -> _ShardContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("a collective runs only inside run_spmd")
    if axis != ctx.mesh.axis_name:
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh's is {ctx.mesh.axis_name!r}")
    return ctx


def axis_index(axis: str) -> int:
    """This shard's index along ``axis`` (``jax.lax.axis_index``)."""
    return _context(axis).my


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` (n, ...) on every shard; returns (n, ...) whose row ``src`` is
    row ``my`` of shard ``src``'s ``x`` (``jax.lax.all_to_all`` over dim 0)."""
    ctx = _context(axis)
    if x.shape[0] != ctx.mesh.size:
        raise ValueError(f"all_to_all takes ({ctx.mesh.size}, ...), got {tuple(x.shape)}")
    g = ctx.exchange("all_to_all", x)
    return torch.stack([b[ctx.my].to(ctx.device) for b in ctx.group.slots[g]])


def all_to_all_ragged(parts: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """``parts[d]`` goes to shard ``d``; returns the list whose entry
    ``src`` is what shard ``src`` sent here. The parts may differ in length
    along dim 0 (the exchange of a process-free mesh need not pad)."""
    ctx = _context(axis)
    if len(parts) != ctx.mesh.size:
        raise ValueError(f"all_to_all_ragged takes {ctx.mesh.size} parts, got {len(parts)}")
    g = ctx.exchange("all_to_all", list(parts))
    return [b[ctx.my].to(ctx.device) for b in ctx.group.slots[g]]


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """(n, ...) stack of every shard's ``x``, in shard order."""
    ctx = _context(axis)
    g = ctx.exchange("all_gather", x)
    return torch.stack([b.to(ctx.device) for b in ctx.group.slots[g]])


def or_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Element-wise OR of every shard's ``x`` (``pmax`` of a boolean),
    folded once, in shard order."""
    ctx = _context(axis)
    g = ctx.exchange("or_reduce", x)
    return ctx.group.folded[g].to(ctx.device)


def run_spmd(mesh: DeviceMesh, body: Callable, *per_shard_args: Sequence) -> List:
    """Run ``body(*args[my])`` once per shard, each on its own thread; return
    the results in shard order.

    Each of ``per_shard_args`` holds one value per shard. Inside ``body``,
    :func:`axis_index` is the shard and the collectives meet the other
    shards; the shards take turns between collectives (:class:`_Group`), so
    every result depends on shard order only. If any body raises, the group
    is broken so that every other shard leaves its collective, every thread
    is joined, and the first error (by shard) that is not the broken group
    itself is raised: no thread outlives the call. Kernel libraries are
    loaded before the threads start, so no build races.
    """
    n = mesh.size
    for a in per_shard_args:
        if len(a) != n:
            raise ValueError(f"one argument per shard: {n} shards, got {len(a)}")
    if getattr(_local, "ctx", None) is not None:
        raise RuntimeError("run_spmd does not nest")
    if any(d.type == "cuda" for d in mesh.devices):
        from ..kernels import build

        build.preload()
    group = _Group(mesh)
    results: List = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def worker(my: int) -> None:
        _local.ctx = _ShardContext(mesh, my, group)
        try:
            group.start(my)
            results[my] = body(*(a[my] for a in per_shard_args))
            group.finish(my)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[my] = e
            group.abort()
        finally:
            _local.ctx = None

    threads = [threading.Thread(target=worker, args=(i,), name=f"{mesh.axis_name}-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        real = [e for e in raised if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or raised)[0]
    return results


# ---------------------------------------------------------------------------
# host-side partitioning
# ---------------------------------------------------------------------------

def partition_rows(rows: np.ndarray, n_shards: int, key_col: int, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) -> (n_shards, cap, 3) hash-partitioned by ``rows[:, key_col]``.

    Returns ``(shards, overflow)`` where ``overflow`` is ``bool[n_shards]``:
    True where a shard received more than ``cap`` rows (the excess rows are
    dropped). Overflow is a flag, not an exception, as ``SideResult.overflow``.
    """
    out = np.full((n_shards, cap, 3), PAD, np.int32)
    overflow = np.zeros((n_shards,), bool)
    if rows.size:
        dest = rows[:, key_col] % n_shards
        for s in range(n_shards):
            mine = rows[dest == s]
            if mine.shape[0] > cap:
                overflow[s] = True
                mine = mine[:cap]
            out[s, : mine.shape[0]] = mine
    return out, overflow


def prepare_target_shards(tau: np.ndarray, n_shards: int, cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(SPO shards by subject, OPS shards by object, overflow), lex-sorted.

    OPS shards store rows permuted to (o, p, s), so the prefix-range probe
    works on them unchanged. ``overflow`` is ``bool[n_shards]``, the OR of
    the two passes' flags.
    """
    spo, ovf_s = partition_rows(tau, n_shards, key_col=0, cap=cap)
    ops_rows = tau[:, [2, 1, 0]] if tau.size else tau
    ops, ovf_o = partition_rows(ops_rows, n_shards, key_col=0, cap=cap)
    for s in range(n_shards):
        spo[s] = spo[s][np.lexsort((spo[s][:, 2], spo[s][:, 1], spo[s][:, 0]))]
        ops[s] = ops[s][np.lexsort((ops[s][:, 2], ops[s][:, 1], ops[s][:, 0]))]
    return spo, ops, ovf_s | ovf_o


def _partition(rows: torch.Tensor, n_shards: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`partition_rows` by ``rows[:, 0]`` on the rows' device (PAD rows
    dropped): each shard keeps the rows' order and its first ``cap`` rows.
    A stable sort by shard, then one scatter whose dropped entries land in a
    spare row and column."""
    dev = rows.device
    valid = rows[:, 0] != PAD
    dest = torch.where(valid, rows[:, 0] % n_shards, n_shards).long()
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    counts = torch.bincount(dest, minlength=n_shards + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.shape[0], device=dev) - starts[dest_s]
    keep = (dest_s < n_shards) & (pos < cap)
    out = torch.full((n_shards + 1, cap + 1, 3), PAD, dtype=torch.int32, device=dev)
    out[torch.where(keep, dest_s, n_shards), torch.where(keep, pos, cap)] = rows[order]
    return out[:n_shards, :cap], counts[:n_shards] > cap


def shard_target_store(tau: TripleStore, n_shards: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`prepare_target_shards` of a store's valid rows, on the store's
    device: (SPO shards int32[n, cap, 3], OPS shards, overflow bool[n])."""
    spo, ovf_s = _partition(tau.spo, n_shards, cap)  # τ is lex-sorted, and so each shard
    ops, ovf_o = _partition(tau.spo[:, [2, 1, 0]], n_shards, cap)
    ops = torch.stack([lex_sort(ops[s]) for s in range(n_shards)])
    return spo, ops, ovf_s | ovf_o


# ---------------------------------------------------------------------------
# cohort -> device placement policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CohortPlacement:
    """cohort id -> mesh device assignment for the broker's placed mode.

    ``mode``:
      ``"round_robin"``    new cohorts cycle through the mesh devices;
      ``"load_balanced"``  a new cohort lands on the device with the least
                           accumulated padded member count (what the step
                           evaluates, padding included);
      ``"pinned"``         explicit ``pins`` lookup (cohort signature ->
                           device index, modulo the mesh size) with
                           ``default`` as the fallback.

    Assignments are sticky: a cohort keeps its device across fires, so its
    τ/ρ state stays resident. Load accounting is additive: a cohort whose
    padded size grows adds the growth to its device's load; departed cohorts
    are not refunded (the estimate only seeds new assignments).
    """

    mode: str = "round_robin"
    pins: Dict[object, int] = dataclasses.field(default_factory=dict)
    default: int = 0

    def __post_init__(self):
        if self.mode not in ("round_robin", "load_balanced", "pinned"):
            raise ValueError(f"unknown placement mode {self.mode!r}")
        self._assigned: Dict[object, int] = {}
        self._sizes: Dict[object, int] = {}
        self._load: Dict[int, int] = {}
        self._rr = itertools.count()

    def assign(self, sig: object, padded_members: int, n_devices: int) -> int:
        """Device index for one cohort signature (sticky across calls),
        always in ``range(n_devices)``: an assignment made on a larger mesh
        folds back into the current one."""
        dev = self._assigned.get(sig)
        if dev is not None:
            dev %= n_devices
        if dev is None:
            if self.mode == "pinned":
                dev = self.pins.get(sig, self.default) % n_devices
            elif self.mode == "load_balanced":
                dev = min(range(n_devices), key=lambda i: self._load.get(i, 0))
            else:
                dev = next(self._rr) % n_devices
            self._assigned[sig] = dev
            self._sizes[sig] = 0
        grown = padded_members - self._sizes[sig]
        if grown > 0:
            self._sizes[sig] = padded_members
            self._load[dev] = self._load.get(dev, 0) + grown
        return dev


# ---------------------------------------------------------------------------
# primitives inside run_spmd
# ---------------------------------------------------------------------------

def _bucketize(vals: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group vals (B,) by dest = val % n into (n, B) buckets (PAD-padded).

    Returns (buckets, dest, pos): value ``i`` sits at ``buckets[dest[i],
    pos[i]]``, in input order within its bucket; PAD values get dest ``n``
    and pos 0 and are dropped.
    """
    b = vals.shape[0]
    dev = vals.device
    live = vals != PAD
    dest = torch.where(live, vals % n, n).long()
    onehot = (dest[:, None] == torch.arange(n, device=dev)[None, :]).long()
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    buckets = torch.full((n + 1, max(b, 1)), PAD, dtype=torch.int32, device=dev)
    buckets[dest, pos] = vals.to(torch.int32)
    return buckets[:n, :b], dest, pos


def _routed_exchange(
    axis: str,
    n_shards: int,
    bound_vals: torch.Tensor,
    local_probe: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send each query to its owner shard, answer there, send the answers back.

    The reference pads every bucket to the whole query vector (XLA's static
    shapes), so each owner probes ``n_shards`` times as many queries as the
    vector holds, nearly all of them PAD. Here a shard sends each owner its
    live queries only, in query order (one count read from the device a
    probe), and each owner probes just what it received. A PAD query gets a
    PAD row and ``valid`` False; every other answer is the owner's, as in
    the reference, where the evaluator reads no row whose ``valid`` is False.
    """
    b = bound_vals.shape[0]
    dev = bound_vals.device
    dest = torch.where(bound_vals != PAD, bound_vals % n_shards, n_shards).long()
    order = torch.sort(dest, stable=True).indices  # by owner, query order within
    counts = torch.bincount(dest, minlength=n_shards + 1)[:n_shards].tolist()
    live = order[: sum(counts)]
    recv = all_to_all_ragged(list(torch.split(bound_vals[live], counts)), axis)
    rows, valid = local_probe(torch.cat(recv))
    sizes = [r.shape[0] for r in recv]
    rows_back = all_to_all_ragged(list(torch.split(rows, sizes)), axis)
    valid_back = all_to_all_ragged(list(torch.split(valid, sizes)), axis)
    my_rows = torch.full((b, fanout, 3), PAD, dtype=rows.dtype, device=dev)
    my_valid = torch.zeros((b, fanout), dtype=torch.bool, device=dev)
    my_rows[live] = torch.cat(rows_back)
    my_valid[live] = torch.cat(valid_back)
    return my_rows, my_valid


def make_routed_probe(axis: str, n_shards: int) -> Callable:
    """The static-pattern probe hook (``make_side_evaluator(probe_impl=...)``):
    ``(index, pattern, bound_slot, bound_vals, fanout)``, each query answered
    by the shard owning its bound value."""

    def routed(index: TripleIndex, pattern, bound_slot, bound_vals, fanout):
        return _routed_exchange(
            axis, n_shards, bound_vals, lambda recv: probe(index, pattern, bound_slot, recv, fanout), fanout
        )

    return routed


def make_routed_probe_batched(axis: str, n_shards: int) -> Callable:
    """The dynamic-pattern probe hook (``dynamic_patterns=True``):
    ``(index, pattern_host, pattern_dev, bound_slot, bound_vals, fanout)``.

    The owner answers from its own hash partition: the partition key is the
    bound slot (subject for SPO probes, object for OPS probes), so the owner
    holds the complete prefix range of every query it receives, and the
    answers, ``fanout`` truncation order included, equal a probe of the
    unpartitioned index. The reference folds a vmapped cohort's member axis
    into one collective; the port's cohort step calls this once per member.
    """

    def routed(index: TripleIndex, pattern_host, pattern_dev, bound_slot, bound_vals, fanout):
        return _routed_exchange(
            axis,
            n_shards,
            bound_vals,
            lambda recv: probe_dyn(index, pattern_host, pattern_dev, bound_slot, recv, fanout),
            fanout,
        )

    return routed


def make_or_reduce(axis: str) -> Callable:
    """Cross-shard OR: boolean tables through one OR fold (the reference's
    ``pmax``), int32 lane-bit words through :func:`all_gather` and a
    bitwise-OR fold in shard order. Shards holding masked, even overlapping,
    subsets of a words tensor reassemble it exactly."""

    def reduce(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            return or_reduce(t, axis)
        gathered = all_gather(t, axis)
        acc = gathered[0]
        for i in range(1, gathered.shape[0]):
            acc = acc | gathered[i]
        return acc

    return reduce


def route_rows_by_key(rows: torch.Tensor, axis: str, n_shards: int, key_col: int = 0) -> torch.Tensor:
    """Send each row to the shard owning ``row[key_col]``; returns (n * N, 3)
    rows now on their owner (PAD-padded, unsorted)."""
    n_rows = rows.shape[0]
    _, dest, pos = _bucketize(rows[:, key_col], n_shards)
    full = torch.full((n_shards + 1, max(n_rows, 1), 3), PAD, dtype=torch.int32, device=rows.device)
    full[dest, pos] = rows.to(torch.int32)
    return all_to_all(full[:n_shards, :n_rows], axis).reshape(-1, 3)


def _count_valid(rows: torch.Tensor) -> torch.Tensor:
    """The valid (non-PAD) rows of int32[..., N, 3] rows, per leading index."""
    return (rows[..., 0] != PAD).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the distributed side evaluator
# ---------------------------------------------------------------------------

def make_distributed_evaluator(
    plan: CompiledInterest,
    mesh: DeviceMesh,
    *,
    id_capacity: int,
    fanout: int = 4,
    out_capacity: int,
    pull_capacity: int,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], SideResult]:
    """Side evaluator over hash-partitioned (M, τ) shards, one thread a shard.

    Inputs (global views, any device; each shard reads its own slice on its
    own device):
      m_shards:   int32[n, m_cap, 3]      changeset rows (any partitioning)
      spo_shards: int32[n, t_cap, 3]      τ partitioned by subject, sorted
      ops_shards: int32[n, t_cap, 3]      τ (o, p, s) partitioned by object
    Returns the per-shard :class:`SideResult`\\ s stacked on a leading axis,
    on the first shard's device.
    """
    axis, n_shards = mesh.axis_name, mesh.size
    evaluator = make_side_evaluator(
        plan,
        id_capacity=id_capacity,
        fanout=fanout,
        out_capacity=out_capacity,
        pull_capacity=pull_capacity,
        probe_impl=make_routed_probe(axis, n_shards),
        table_reduce=make_or_reduce(axis),
    )

    def shard_fn(m_rows, spo_rows, ops_rows):
        m_store = TripleStore(spo=lex_sort(m_rows), n=_count_valid(m_rows))
        tgt = TripleIndex(
            spo=TripleStore(spo=spo_rows, n=_count_valid(spo_rows)),
            ops=TripleStore(spo=ops_rows, n=_count_valid(ops_rows)),
        )
        return evaluator(m_store, tgt)

    def run(m_shards: torch.Tensor, spo_shards: torch.Tensor, ops_shards: torch.Tensor) -> SideResult:
        per = [
            [x[i].to(mesh.devices[i]) for i in range(n_shards)] for x in (m_shards, spo_shards, ops_shards)
        ]
        res = run_spmd(mesh, shard_fn, *per)
        home = mesh.devices[0]

        def stack(field: str) -> TripleStore:
            stores = [getattr(r, field) for r in res]
            return TripleStore(
                spo=torch.stack([s.spo.to(home) for s in stores]),
                n=torch.stack([s.n.to(home) for s in stores]),
            )

        return SideResult(
            interesting=stack("interesting"),
            potential=stack("potential"),
            pulls=stack("pulls"),
            overflow=torch.stack([r.overflow.to(home) for r in res]),
        )

    return run


def gather_result_sets(res: SideResult, partition_overflow=None):
    """Union the per-shard outputs into host-side sets (for tests and stats).

    Returns ``(interesting, potential, pulls, overflow)``; ``overflow`` ORs
    the per-shard flags with any host-side partition flags passed in (one
    or more ``bool[n_shards]`` arrays from :func:`partition_rows` /
    :func:`prepare_target_shards`), so a pipeline sees every capacity
    violation through one value.
    """

    def rows_of(store_stacked):
        arr = store_stacked.spo.cpu().numpy().reshape(-1, 3)
        return {tuple(int(x) for x in r) for r in arr if r[0] != PAD}

    overflow = bool(res.overflow.any())
    if partition_overflow is not None:
        overflow = overflow or bool(np.any(np.asarray(partition_overflow)))
    return rows_of(res.interesting), rows_of(res.potential), rows_of(res.pulls), overflow
