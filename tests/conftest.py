def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (runs the port's kernels on the card; "
        "skips elsewhere)")
