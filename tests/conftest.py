import pytest  # noqa: F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "subprocess: spawns EngineWorker subprocesses (each builds its "
        "own jax runtime — the multiprocess disagg smoke; select with "
        "-m subprocess)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's hand-written "
        "kernels); skips without one — run with -m cuda on the card")
