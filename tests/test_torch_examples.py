"""The port's example scripts (examples/torch_*.py) against the JAX package's
(examples/*.py) on the CPU, at small sizes: the same answer lines, in the same
order. The port's scripts run in this process through `main(["--on", "cpu",
...])`; the JAX scripts run once each, all at once, in subprocesses on the CPU.

The only lines not compared as printed are the ones listed in DROPPED and
REWRITTEN: a line that names a device, the `LimbPlanes` wording of the JAX
tour's step 10 (the port reads a u64 column as a native uint64 tensor), and
the timing lines."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from fastlanes_tpu import native as jax_native
from fastlanes_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: example -> its size argument here (the JAX script's CPU default where none)
SIZES = {"float_columns": [], "end_to_end": [], "compressed_scan": ["64"],
         "query_tour": ["3000"], "table_analytics": ["20000"]}

#: example -> prefixes of the lines left out of the comparison
DROPPED = {
    "end_to_end": ("devices: ",),  # the device list
    "compressed_scan": ("scanned ",),  # the timing line
    "table_analytics": ("on-chip decode+filter+aggregate: ",),  # the timing line
}
#: example -> (JAX wording, port wording) replaced in the JAX script's lines
REWRITTEN = {"end_to_end": ("10. u64 file -> LimbPlanes(", "10. u64 file -> torch.uint64 tensor(")}

#: what a fresh interpreter prints after running a script under --on cpu
_FRESH = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "fastlanes_tpu")))
"""


def compared(name, text):
    drop = DROPPED.get(name, ())
    old, new = REWRITTEN.get(name, ("", ""))
    return [line.replace(old, new) if old else line
            for line in text.splitlines() if not line.startswith(drop)]


def load(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs():
    """Started together: each JAX script on the CPU, and each port script in
    a fresh interpreter under --on cpu. Yields name -> (jax, fresh) Popen.
    Both packages' host codecs are built here first, so that the scripts
    load them and no two of them compile one."""
    jax_native.available()
    native.available()
    env = dict(os.environ, FASTLANES_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    # one host device, as a user's run has (conftest.py asks JAX for eight)
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "").strip()

    def start(*argv):
        return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    procs = {name: (start(f"examples/{name}.py", *size),
                    start("-c", _FRESH, f"examples/torch_{name}.py", "--on", "cpu", *size))
             for name, size in SIZES.items()}
    yield procs
    for pair in procs.values():
        for proc in pair:
            proc.kill()
            proc.communicate()


def finished(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_answer_lines_equal_the_jax_script(runs, name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        answers = load(name).main(["--on", "cpu", *SIZES[name]])
    json.dumps(answers)  # plain Python values
    assert compared(name, buf.getvalue()) == compared(name, finished(runs[name][0]))


@pytest.mark.parametrize("name", list(SIZES))
def test_script_loads_nothing_of_jax(runs, name):
    last = finished(runs[name][1]).splitlines()[-1]
    assert last == "LOADED []"


@pytest.mark.parametrize("name", list(SIZES))
def test_default_is_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main(SIZES[name])
