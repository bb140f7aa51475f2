"""Training data pipeline of the port (port of ``repro.data``)."""
