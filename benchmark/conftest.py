"""pytest settings of the benchmark's own tests (benchmark/tests): the
`card` marker for tests that need a CUDA card.  Such a test decides inside
itself whether there is one, and skips with the reason where there is
none; nothing is decided while a module is imported."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
