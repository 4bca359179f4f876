"""The benchmark's own tests: `python3 -m pytest isp_bench/tests -q` from
the root of the checkout. Tests marked `cuda` need an NVIDIA card and skip
(inside the test) without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA device")
