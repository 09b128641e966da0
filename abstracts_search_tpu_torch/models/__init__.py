"""Query encoders. Only the offline ``HashEmbedder`` is ported so far;
the stella encoder is still to be ported."""

from .registry import HashEmbedder, get_embedder

__all__ = ["HashEmbedder", "get_embedder"]
