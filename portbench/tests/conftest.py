"""Shared pieces of the benchmark's own tests (``python -m pytest
portbench/tests`` from the repository root).  Tests that need the card
are marked ``cuda`` and skip inside a fixture where there is none."""

import copy
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is false")


def tiny_cell(workload: str, n: int = 32, width: int = 96, height: int = 54):
    """A benchmark cell as its files define it, at a size a CPU test can
    hold: the scene's lattice edge and the image cut, nothing else (16:9
    like 1080p, so the frames take the same routes)."""
    from portbench import harness

    cell = harness.load_cell(workload, ROOT / "BENCHMARK.json")
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene"].update(n=n, cache=False)
    cell.config["render"].update(width=width, height=height)
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
