"""Input pipeline (``data``: sequence packing, prefetch) and timeline
tracing (``tracing``)."""
