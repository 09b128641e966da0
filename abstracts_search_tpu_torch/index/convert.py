"""Carry a trained, filled IVF-PQ index across in memory.

``index_from_numpy`` builds the port's index from plain numpy state: the
artifact's meta keys, the coarse centroids, the PQ codebooks, the
rotation and the CSR lists (any object with ``CSRLists``' fields, such
as the JAX package's). The on-disk route, ``IVFPQIndex.save`` /
``IVFPQIndex.load``, carries the same state through the same format.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ivfpq import IVFPQIndex
from .lists import CSRLists


def index_from_numpy(meta: dict, centroids, pq_centroids, rotation, csr, *,
                     device=None, **kw) -> IVFPQIndex:
    """``meta`` holds the ``meta.json`` keys n_lists, dim, pq_m,
    pq_nbits, use_opq, seg_size and spherical; ``csr`` may be None for a
    trained but unfilled index. ``kw`` goes to ``IVFPQIndex``."""
    idx = IVFPQIndex(meta["n_lists"], meta["dim"], pq_m=meta["pq_m"],
                     pq_nbits=meta["pq_nbits"], use_opq=meta["use_opq"],
                     seg_size=meta["seg_size"],
                     spherical=meta.get("spherical", True), device=device,
                     _legacy_unnormalized=not meta.get("spherical", True), **kw)
    idx.set_params(np.asarray(centroids), np.asarray(pq_centroids),
                   np.asarray(rotation))
    if csr is not None:
        fields = {f.name: getattr(csr, f.name) for f in dataclasses.fields(CSRLists)}
        idx._install(CSRLists(**fields))
    return idx
