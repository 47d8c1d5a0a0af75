"""Synthetic DBpedia-Live-like changeset stream (copy of ``repro.data.changeset_gen``)."""
from .changeset_gen import DBpediaLikeGenerator, GeneratorConfig

__all__ = ["DBpediaLikeGenerator", "GeneratorConfig"]
