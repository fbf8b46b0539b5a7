"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` on the
CPU; the card-only tests (marked ``gpu``) with
``python -m pytest -m gpu portbench/tests`` on a machine with a CUDA card."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (python -m pytest -m gpu portbench/tests)")
