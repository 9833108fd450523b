import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU replay steps over tiny tensors: one intra-op thread
    is enough, and leaves the cores to the suite's other workers."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
