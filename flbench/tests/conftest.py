"""The benchmark's own tests: CPU at tiny sizes (`device="cpu"`), and tests
marked `cuda` that skip without a card. Run them from the repository root:

    python -m pytest flbench/tests -q -p no:cacheprovider
"""

import glob
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class ConfigSizes(dict):
    """The test size of each configuration: the `SMALL` overrides of its
    generator, flbench/configs/<name>.py. A test that asks for the size of a
    configuration without one skips; test_every_configuration_has_a_test_size
    fails for it and names the file."""

    def __missing__(self, name):
        pytest.skip(f"{name} has no test size: give flbench/configs/{name}.py a SMALL")


def config_names() -> list:
    """The name of every configuration: flbench/configs/<name>.json."""
    from flbench import dataset

    return sorted(os.path.basename(p)[:-len(".json")]
                  for p in glob.glob(os.path.join(dataset.HERE, "configs", "*.json")))


def config_sizes() -> ConfigSizes:
    """The test size of every configuration that has one."""
    from flbench import dataset

    out = ConfigSizes()
    for name in config_names():
        small = getattr(dataset.load_module("configs", name), "SMALL", None)
        if small is not None:
            out[name] = small
    return out


SMALL = config_sizes()


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def needs_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
