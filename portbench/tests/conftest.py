def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (decided inside the test)")
