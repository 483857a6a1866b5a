"""The benchmark's own tests: CPU at tiny sizes (`device="cpu"`), and tests
marked `cuda` that skip without a card. Run them from the repository root:

    python -m pytest flbench/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: configuration overrides that cut each configuration to a size a test holds:
#: several chunks a column and several lockstep windows
SMALL = {
    "tpch-lineitem-sf1": {"orders": 6000, "parts": 20000, "suppliers": 1000,
                          "text_pool_bytes": 1 << 16,
                          "file": {"writer": "fio_table.write_table", "codec": "auto",
                                   "chunk_blocks": 1}},
    "tpch-lineitem-sf4": {"orders": 3000, "parts": 20000, "suppliers": 1000,
                          "text_pool_bytes": 1 << 16,
                          "file": {"writer": "fio_table.write_table", "codec": "auto",
                                   "chunk_blocks": 1}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def needs_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
