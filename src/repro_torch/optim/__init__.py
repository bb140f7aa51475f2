"""Optimizers and schedules of the port (port of ``repro.optim``)."""
