"""PyTorch + CUDA port of the iRap reproduction (``repro``), slice by slice.

It holds the paper's single-interest pipeline (dictionary ids, triple-set
algebra, interest compilation, side evaluation, ``IrapEngine``) and the
multi-subscriber ``Broker`` with its pattern bank, push policies, deferred
flush with delta frontier chains and the subsumption lattice
(``repro_torch.core``), on hand-written Hopper kernels for the pattern
bitset, the lexicographic probe, the bank words, the fused lane routing,
the segmented bank words and the lane refinement (``repro_torch.kernels``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import core, kernels
from .core import (
    Broker,
    BrokerStats,
    BrokerSubscription,
    ChangesetBatch,
    Dictionary,
    EvalOutputs,
    IncrementalPatternBank,
    InterestExpr,
    IrapEngine,
    PushPolicy,
    StepCapacities,
    TripleStore,
    compile_interest,
    make_broker_step,
    to_numpy,
    to_set,
)

__all__ = [
    "Broker",
    "BrokerStats",
    "BrokerSubscription",
    "ChangesetBatch",
    "Dictionary",
    "EvalOutputs",
    "IncrementalPatternBank",
    "InterestExpr",
    "IrapEngine",
    "PushPolicy",
    "StepCapacities",
    "TripleStore",
    "compile_interest",
    "core",
    "kernels",
    "make_broker_step",
    "to_numpy",
    "to_set",
]
