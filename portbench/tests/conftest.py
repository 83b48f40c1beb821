"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.
Tests marked ``card`` need a CUDA card and skip without one (decided in
the ``card`` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the H100")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from portbench.tests import tiny

    torch.set_num_threads(4)
    return tiny.write_tiny_root(str(tmp_path_factory.mktemp("tiny")))
