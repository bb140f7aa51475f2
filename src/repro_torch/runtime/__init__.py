"""Training runtime of the port (port of ``repro.runtime``)."""
