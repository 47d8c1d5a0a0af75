"""PyTorch + CUDA port of the iRap reproduction (``repro``), slice by slice.

It holds the paper's single-interest pipeline (dictionary ids, triple-set
algebra, interest compilation, side evaluation, ``IrapEngine``) and the
multi-subscriber ``Broker`` with its pattern bank, push policies, deferred
flush with delta frontier chains, the subsumption lattice, and its
write-ahead journal, delivery channel, snapshots and crash recovery
(``repro_torch.core``, ``repro_torch.checkpoint``; the fault harness in
``repro_torch.testing``), on hand-written Hopper kernels for the pattern
bitset, the lexicographic probe, the bank words, the fused lane routing,
the segmented bank words and the lane refinement (``repro_torch.kernels``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import checkpoint, core, kernels, testing
from .core import (
    Broker,
    BrokerStats,
    BrokerSubscription,
    ChangesetBatch,
    ChangesetJournal,
    DeliveryChannel,
    DeliveryStats,
    Dictionary,
    EvalOutputs,
    IncrementalPatternBank,
    InterestExpr,
    IrapEngine,
    JournalRecord,
    PushPolicy,
    StepCapacities,
    TripleStore,
    compile_interest,
    make_broker_step,
    make_cohort_step,
    to_numpy,
    to_set,
)

__all__ = [
    "Broker",
    "BrokerStats",
    "BrokerSubscription",
    "ChangesetBatch",
    "ChangesetJournal",
    "DeliveryChannel",
    "DeliveryStats",
    "Dictionary",
    "EvalOutputs",
    "IncrementalPatternBank",
    "InterestExpr",
    "IrapEngine",
    "JournalRecord",
    "PushPolicy",
    "StepCapacities",
    "TripleStore",
    "checkpoint",
    "compile_interest",
    "core",
    "kernels",
    "make_broker_step",
    "make_cohort_step",
    "to_numpy",
    "testing",
    "to_set",
]
