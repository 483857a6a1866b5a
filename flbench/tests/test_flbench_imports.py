"""No module a run loads has the top-level name jax, jaxlib, flax or
fastlanes_tpu (the port's name begins with the JAX package's, so names are
compared whole), and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

LOAD_ALL = r"""
import glob, json, os, sys
from flbench import control, dataset, run, trace, traffic, work
for path in sorted(glob.glob("flbench/configs/*.json")):
    dataset.load_config(os.path.basename(path)[:-5])
for path in sorted(glob.glob("flbench/traffic/*.json")):
    spec = traffic.load(os.path.basename(path)[:-5])
    entry = spec["entry"].rsplit(".", 1)[1]
    run._module("entries", entry)
    run._module("reference", entry)
    run._program_entry(spec["entry"])
for path in sorted(glob.glob("flbench/metrics/*.py")):
    run._module("metrics", os.path.basename(path)[:-3])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = r"""
import glob, json, os, sys
from flbench import dataset
for path in sorted(glob.glob("flbench/reference/*.py")):
    name = os.path.basename(path)[:-3]
    if name != "__init__":
        dataset.load_module("reference", name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _loaded(LOAD_ALL)
    assert "fastlanes_tpu_torch" in names and "flbench" in names
    assert not names & {"jax", "jaxlib", "flax", "fastlanes_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(LOAD_REFERENCE)
    assert not names & {"fastlanes_tpu_torch", "jax", "jaxlib", "flax", "fastlanes_tpu"}
