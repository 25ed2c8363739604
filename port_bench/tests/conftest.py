"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need the CUDA card (``python -m pytest port_bench/tests -m
card`` on the card machine).  Whether a card exists is decided inside the
``card_device`` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", 0)


def tiny_serve(size: int = 64):
    """A serving cell shrunk so that a CPU test run holds it."""
    return {"config": {"imgsz": size},
            "mix": {"batch": 2, "pool": 4, "native_hw": [size * 9 // 8, size * 2],
                    "check_from": 2, "check_batches": 1, "trace_from": 1, "trace_steps": 1}}


def tiny_train(size: int = 64):
    return {"config": {"imgsz": size},
            "mix": {"batch": 2, "batches": 5, "max_boxes": 4, "trace_from": 0,
                    "trace_steps": 1}}
