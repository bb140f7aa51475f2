"""Model layers, the mixer registry and the hybrid LM (port of
``repro.models``)."""
