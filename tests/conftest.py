def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess integration tests"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skips without one"
    )
