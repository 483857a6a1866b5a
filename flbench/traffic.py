"""The one traffic generator: reads a mix from `traffic/<name>.json` and draws
its calls from the seed.

A mix names one timed entry of the program and a query, a list of calls
that share parameters drawn once a query:

  {"entry": "analytics.group_stats",          module.function of the program
   "params": {"DELTA": {"int_uniform": [60, 120]}},
   "query": {"for": {"s": ["F", "O"], "v": ["l_tax"]},   nested loops, in order
             "call": {...keyword arguments...},
             "label": "group_stats $v $s"},
   "sample_answers": 12,                      answers compared after the window,
   "sample_per_label": 2}                     and of each call label at least

Values in "call" are literals, "$name" (a parameter or a loop variable), or
one-key objects: {"file": key} the path of a file of the dataset,
{"files": "all"} every path, {"date": [y, m, d]}, {"date_minus_days":
[date, n]}, {"cents": n} (the double nearest n / 100), {"add": [a, b]},
{"sub": [a, b]}. Parameters are {"int_uniform": [lo, hi]} (both ends
included) or {"choice": [...]}.

Calls are issued one after another by one client (a closed loop): the next
one when the last has returned.
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass

import numpy as np

from .dataset import HERE, rng_of


@dataclass
class Call:
    entry: str
    kwargs: dict
    label: str


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _draw(spec: dict, rng: np.random.Generator):
    (kind, arg), = spec.items()
    if kind == "int_uniform":
        return int(rng.integers(arg[0], arg[1] + 1))
    if kind == "choice":
        return arg[int(rng.integers(0, len(arg)))]
    raise ValueError(f"unknown parameter kind {kind!r}")


def _value(x, env: dict, dataset):
    if isinstance(x, str) and x.startswith("$"):
        return env[x[1:]]
    if isinstance(x, list):
        return [_value(v, env, dataset) for v in x]
    if not isinstance(x, dict):
        return x
    (op, arg), = x.items()
    arg = _value(arg, env, dataset)
    if op == "file":
        return dataset.path(arg)
    if op == "files":
        if arg != "all":
            raise ValueError(f"files: {arg!r}")
        return dataset.paths()
    if op == "date":
        return np.datetime64("%04d-%02d-%02d" % tuple(arg), "D")
    if op == "date_minus_days":
        return np.datetime64(arg[0], "D") - np.timedelta64(int(arg[1]), "D")
    if op == "cents":
        return int(arg) / 100
    if op == "add":
        return arg[0] + arg[1]
    if op == "sub":
        return arg[0] - arg[1]
    raise ValueError(f"unknown traffic expression {op!r}")


def _label(template: str, env: dict) -> str:
    for name in sorted(env, key=len, reverse=True):
        template = template.replace("$" + name, str(env[name]))
    return template


class Traffic:
    """The calls of one mix over one dataset, drawn from one stream of the
    seed."""

    def __init__(self, spec: dict, dataset, seed: int, stream: int = 1):
        self.spec, self.dataset = spec, dataset
        self.rng = rng_of(seed, stream)

    def query(self) -> list:
        """The calls of the next query."""
        env = {k: _draw(v, self.rng) for k, v in self.spec.get("params", {}).items()}
        q = self.spec["query"]
        loops = q.get("for", {})
        calls = []
        for combo in itertools.product(*loops.values()):
            e = dict(env, **dict(zip(loops, combo)))
            calls.append(Call(self.spec["entry"],
                              {k: _value(v, e, self.dataset) for k, v in q["call"].items()},
                              _label(q.get("label", self.spec["entry"]), e)))
        return calls

    def calls(self):
        """Every call, query after query, without end."""
        while True:
            yield from self.query()
