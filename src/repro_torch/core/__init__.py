"""iRap core on PyTorch: the single-interest pipeline (Defs 6, 11-18) and the
multi-subscriber broker (deferred flush with delta frontier chains, the
subsumption lattice, the write-ahead journal and the delivery channel,
cohort placement and sharding over a device mesh).

Public API:
  Dictionary, TripleStore + set algebra      (repro_torch.core.{dictionary,triples})
  InterestExpr / compile_interest            (repro_torch.core.interest)
  IncrementalPatternBank / build_pattern_bank
  canonicalize_expr / SubsumptionBank
  make_side_evaluator / TripleIndex          (repro_torch.core.evaluation)
  make_interest_step / IrapEngine            (repro_torch.core.propagation)
  compose_changesets / ChangesetBatch
  FrontierChain / build_frontier_chain
  Broker / PushPolicy / make_broker_step     (repro_torch.core.broker)
  make_cohort_step / make_sharded_cohort_step
  DeviceMesh / CohortPlacement               (repro_torch.core.distributed)
  make_distributed_evaluator
  partition_rows / prepare_target_shards
  ChangesetJournal / JournalRecord           (repro_torch.core.journal)
  DeliveryChannel / DeliveryStats            (repro_torch.core.delivery)
  load_dictionary / carry_subscription /     (repro_torch.core.state)
  carry_broker
"""
from .broker import (
    Broker,
    BrokerStats,
    BrokerSubscription,
    PushPolicy,
    make_broker_step,
    make_cohort_step,
    make_sharded_cohort_step,
)
from .delivery import DeliveryChannel, DeliveryStats
from .dictionary import Dictionary, parse_triples
from .distributed import (
    CohortPlacement,
    DeviceMesh,
    gather_result_sets,
    make_distributed_evaluator,
    partition_rows,
    prepare_target_shards,
    run_spmd,
)
from .evaluation import (
    SideResult,
    TripleIndex,
    build_index,
    make_side_evaluator,
    probe,
    probe_dyn,
)
from .journal import ChangesetJournal, JournalRecord
from .interest import (
    CompiledInterest,
    IncrementalPatternBank,
    InterestCompileError,
    InterestExpr,
    PatternBank,
    SubsumptionBank,
    TriplePattern,
    build_pattern_bank,
    canonicalize_expr,
    compile_interest,
    next_pow2,
)
from .oracle import OracleEvaluator
from .propagation import (
    ChangesetBatch,
    ChangesetStats,
    EvalOutputs,
    FrontierChain,
    InterestSubscription,
    IrapEngine,
    StepCapacities,
    build_frontier_chain,
    combine_side_results,
    compose_changesets,
    make_interest_step,
    resolve_device,
)
from .state import carry_broker, carry_subscription, load_dictionary, load_store
from .triples import (
    PAD,
    WILDCARD,
    TripleStore,
    apply_changeset,
    difference,
    empty,
    from_array,
    from_numpy,
    intersection,
    lex_sort,
    member,
    prefix_range,
    rehome,
    searchsorted_rows,
    to_numpy,
    to_set,
    union,
)

__all__ = [name for name in dir() if not name.startswith("_")]
