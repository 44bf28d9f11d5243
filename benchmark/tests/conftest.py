"""Tests of the benchmark harness. They run on the CPU at small sizes;
the ones marked ``gpu`` need a CUDA card and skip without one (run them
on the card with ``python -m pytest benchmark/tests -m gpu``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips without one)")
