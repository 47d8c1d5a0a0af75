"""Data plane: the synthetic DBpedia-Live-like stream (a copy of
``repro.data.changeset_gen``), the verbalizer and the replica-fed batches."""
from .changeset_gen import DBpediaLikeGenerator, GeneratorConfig
from .pipeline import ReplicaTokenPipeline
from .verbalizer import Verbalizer

__all__ = ["DBpediaLikeGenerator", "GeneratorConfig", "ReplicaTokenPipeline", "Verbalizer"]
