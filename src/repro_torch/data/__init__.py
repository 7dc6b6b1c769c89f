"""Data pipelines (twin of ``repro.data``)."""
