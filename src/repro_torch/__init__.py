"""PyTorch + CUDA port of the iRap reproduction (``repro``), slice by slice.

This slice holds the paper's single-interest pipeline: dictionary ids,
triple-set algebra, interest compilation, side evaluation and the
``IrapEngine`` (``repro_torch.core``), with hand-written Hopper kernels for
the pattern bitset and the lexicographic probe (``repro_torch.kernels``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import core, kernels
from .core import (
    Dictionary,
    EvalOutputs,
    InterestExpr,
    IrapEngine,
    StepCapacities,
    TripleStore,
    compile_interest,
    to_numpy,
    to_set,
)

__all__ = [
    "Dictionary",
    "EvalOutputs",
    "InterestExpr",
    "IrapEngine",
    "StepCapacities",
    "TripleStore",
    "compile_interest",
    "core",
    "kernels",
    "to_numpy",
    "to_set",
]
