"""Data pipelines of the port (the port of ``repro.data``)."""
