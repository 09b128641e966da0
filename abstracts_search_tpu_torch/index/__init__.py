"""Flat and IVF-PQ search indexes, the IVF-PQ build (k-means, PQ, OPQ)
and the CSR list artifacts (format 3, shared with the JAX package)."""

from .convert import index_from_numpy
from .flat import FlatIndex
from .ivfpq import IVFPQIndex
from .kmeans import KMeans
from .lists import (CSRLists, load_lists, pack_lists, pack_lists_external, resegment_lists,
                    save_lists)
from .opq import OPQ
from .pq import ProductQuantizer

__all__ = ["CSRLists", "FlatIndex", "IVFPQIndex", "KMeans", "OPQ", "ProductQuantizer",
           "index_from_numpy", "load_lists", "pack_lists", "pack_lists_external",
           "resegment_lists", "save_lists"]
