"""Flat and IVF-PQ search indexes, and the IVF-PQ CSR list artifacts
(format 3, shared with the JAX package)."""

from .convert import index_from_numpy
from .flat import FlatIndex
from .ivfpq import IVFPQIndex
from .lists import CSRLists, load_lists, save_lists

__all__ = ["CSRLists", "FlatIndex", "IVFPQIndex", "index_from_numpy", "load_lists",
           "save_lists"]
