"""Shared pytest config. NOTE (spec): never set
xla_force_host_platform_device_count here — smoke tests and benches must
see 1 device; multi-device tests run in subprocesses."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (multi-device subprocess runs, multi-"
        "round differential engine comparisons); excluded from the fast "
        "CI lane via -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a hand-written CUDA kernel has no CPU "
        "mode); skips without one — run on the GPU with -m cuda")
