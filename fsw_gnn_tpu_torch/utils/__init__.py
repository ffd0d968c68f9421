"""Utilities of the port.  `utils.autotune` (which imports the embedding)
is a module of its own, imported where it is used."""
from .cache import CountingGraph, enable_compilation_cache
from .dsmetric import dsmetric
from .profiling import SectionTimer, named_scope, trace
from .validate import (FloatCheckError, checkify_embed, validate_edge_index,
                       validate_graph, validate_multiset_inputs)

__all__ = ['CountingGraph', 'FloatCheckError', 'SectionTimer',
           'checkify_embed', 'dsmetric', 'enable_compilation_cache',
           'named_scope', 'trace', 'validate_edge_index', 'validate_graph',
           'validate_multiset_inputs']
