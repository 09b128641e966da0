"""OpenAlex ingest: the manifest (``manifest``), the works filter, native
and Python (``oa_filter``), and the stamped incremental sync into the
embedding store (``sync``)."""

from .oa_filter import OaJsonlFilter, ensure_filter_built, filter_works_lines

__all__ = ["OaJsonlFilter", "ensure_filter_built", "filter_works_lines"]
