import pytest
import torch


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none (decided
    here, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
