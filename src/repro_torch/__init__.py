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
A ``DeviceMesh`` of devices of this one process carries the broker's cohort
placement and sharded cohort step (``repro_torch.core.distributed``).
The model plane serves the reference's attention families
(``repro_torch.models``, ``repro_torch.configs``; weights carried from the
reference by ``repro_torch.models.convert``), with interest-filtered
parameter sync (``repro_torch.core.param_sync``), replica-fed token batches
(``repro_torch.data``) and a serving driver (``repro_torch.launch.serve``).
Training runs on autograd: AdamW, its schedules and error-feedback int8
compression (``repro_torch.optim``), the fault-tolerant ``Trainer``
(``repro_torch.runtime``) and a training driver fed by a replica
(``repro_torch.launch.train``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import checkpoint, core, kernels, optim, runtime, testing
from .core import (
    Broker,
    BrokerStats,
    BrokerSubscription,
    ChangesetBatch,
    ChangesetJournal,
    CohortPlacement,
    DeliveryChannel,
    DeliveryStats,
    DeviceMesh,
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
    make_distributed_evaluator,
    make_sharded_cohort_step,
    partition_rows,
    prepare_target_shards,
    to_numpy,
    to_set,
)

__all__ = [
    "Broker",
    "BrokerStats",
    "BrokerSubscription",
    "ChangesetBatch",
    "ChangesetJournal",
    "CohortPlacement",
    "DeliveryChannel",
    "DeliveryStats",
    "DeviceMesh",
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
    "make_distributed_evaluator",
    "make_sharded_cohort_step",
    "optim",
    "partition_rows",
    "prepare_target_shards",
    "runtime",
    "to_numpy",
    "testing",
    "to_set",
]
