"""iRap core on PyTorch: the paper's single-interest pipeline (Defs 6, 11-18).

Public API:
  Dictionary, TripleStore + set algebra      (repro_torch.core.{dictionary,triples})
  InterestExpr / compile_interest            (repro_torch.core.interest)
  make_side_evaluator / TripleIndex          (repro_torch.core.evaluation)
  make_interest_step / IrapEngine            (repro_torch.core.propagation)
  load_dictionary / carry_subscription       (repro_torch.core.state)
"""
from .dictionary import Dictionary, parse_triples
from .evaluation import SideResult, TripleIndex, build_index, make_side_evaluator, probe
from .interest import (
    CompiledInterest,
    InterestCompileError,
    InterestExpr,
    TriplePattern,
    compile_interest,
    next_pow2,
)
from .oracle import OracleEvaluator
from .propagation import (
    ChangesetStats,
    EvalOutputs,
    InterestSubscription,
    IrapEngine,
    StepCapacities,
    combine_side_results,
    make_interest_step,
    resolve_device,
)
from .state import carry_subscription, load_dictionary, load_store
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
