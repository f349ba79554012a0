import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (run on "
                            "the card: python -m pytest benchmark/tests -m "
                            "cuda)")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device; decided when the test
    runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
