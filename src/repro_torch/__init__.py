"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

Module names mirror ``repro``'s, so each module's counterpart is easy to
find.  The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro`` — and its entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
