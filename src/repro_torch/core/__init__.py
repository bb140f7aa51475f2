"""GDN recurrence math (port of ``repro.core``)."""
