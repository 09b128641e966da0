"""IVF-PQ search index and its CSR list artifacts (format 3, shared
with the JAX package)."""

from .convert import index_from_numpy
from .ivfpq import IVFPQIndex
from .lists import CSRLists, load_lists, save_lists

__all__ = ["CSRLists", "IVFPQIndex", "index_from_numpy", "load_lists", "save_lists"]
