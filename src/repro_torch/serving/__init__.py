"""Serving: sampler, device executor, scheduler, engine (port of
``repro.serving``, base tick only)."""
