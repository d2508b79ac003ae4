"""Paper-study entry points of the port (counterpart of
``repro/benchmarks_impl``)."""
