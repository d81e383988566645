"""pytest settings for the benchmark's own tests (``benchmark/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "python3 -m pytest benchmark/tests -m card; skipped on a machine without one")
