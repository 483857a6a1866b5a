"""A configuration's data: generated from the seed, written with the
program's own writer inside the checkout, and handed to the traffic, the
entries and the reference.

The generator of a configuration (`configs/<name>.py`) defines:

  VERSION                          bumped whenever what it makes changes
  generate(config, seed) -> data   {file key: {column: array}}; a plain file's
                                   one column is keyed None, a string column is
                                   a `Categorical`
  write(config, data, out_dir) -> files
                                   writes every file with the program's own
                                   writer: {file key: {"path": relative path,
                                   "rows": n}}
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import struct
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: where each run writes its configuration's files: one directory a configuration
DATA_DIR = os.path.join(HERE, "_cache", "data")


class Categorical:
    """A string column as codes into its sorted labels (the generated form;
    the writer receives `strings()`)."""

    def __init__(self, codes: np.ndarray, labels):
        labels = np.asarray(labels)
        if labels.size > 1 and not (labels[:-1] < labels[1:]).all():
            raise ValueError("labels must be sorted and distinct")
        self.codes, self.labels = codes, labels

    def __len__(self) -> int:
        return self.codes.size

    def strings(self) -> np.ndarray:
        return self.labels[self.codes]


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a seed: 0 data, 1 traffic, 2 samples,
    3 warm-up. Any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence(
        entropy=[abs(int(seed)), int(seed < 0)], spawn_key=(stream,)))


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py` of the benchmark, loaded from its file
    (a name may hold '-' and '.') as a module of the package flbench.<kind>."""
    modname = "flbench.%s.%s" % (kind, re.sub(r"[^0-9A-Za-z_]", "_", name))
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            modname, os.path.join(HERE, kind, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]


def load_config(name: str, overrides=None) -> tuple:
    """(config dict, generator module) of configuration `name`."""
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        config = json.load(f)
    config.update(overrides or {})
    gen = load_module("configs", name)
    return config, gen


def read_header(path: str) -> dict:
    """The JSON header of an FLT file or table, read by the benchmark itself:
    the magic, a little-endian u32 length, the header."""
    with open(path, "rb") as f:
        head = f.read(7)
        magic = b"FLTTAB1" if head == b"FLTTAB1" else head[:6]
        if magic not in (b"FLTTAB1", b"FLTPU1"):
            raise ValueError(f"{path}: not an FLT file")
        f.seek(len(magic))
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))


class Dataset:
    """The files of one configuration at one seed, and the generated columns
    they were written from."""

    def __init__(self, config: dict, seed: int, gen, root: str, files: dict, data: dict,
                 seconds=None):
        self.config, self.seed, self.gen = config, seed, gen
        #: seconds of set-up by step: generate, write (the program's writer), fsync
        self.seconds = seconds or {}
        self.root = root
        self.files = files
        self.data = data
        #: what the benchmark derives from the generated columns, by key, and
        #: the lock of its keys
        self.memo = {}
        self.lock = threading.Lock()
        self._headers = {}
        self._by_path = {self.path(k): k for k in files}

    def path(self, key: str) -> str:
        return os.path.join(self.root, self.files[key]["path"])

    def paths(self) -> list:
        return [self.path(k) for k in self.files]

    def key_of(self, path: str) -> str:
        return self._by_path[path]

    def rows(self, path: str) -> int:
        return int(self.files[self.key_of(path)]["rows"])

    def column(self, path: str, column=None):
        return self.data[self.key_of(path)][column]

    def header(self, path: str) -> dict:
        if path not in self._headers:
            self._headers[path] = read_header(path)
        return self._headers[path]

    def chunks(self, path: str, column=None) -> list:
        """The chunk list of a file or of a table's column, from its header."""
        h = self.header(path)
        return h["columns"][column]["chunks"] if column is not None else h["chunks"]


def build(config_name: str, seed: int, overrides=None, data_dir=DATA_DIR) -> Dataset:
    """The dataset of a configuration at a seed, generated and written anew
    in every run into the configuration's directory (what an older run left
    there is removed first) and flushed to disk: every run's set-up does the
    same work, and no write-back of it runs in the window."""
    config, gen = load_config(config_name, overrides)
    root = os.path.join(data_dir, config_name)
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    t0 = time.perf_counter()
    data = gen.generate(config, seed)
    t1 = time.perf_counter()
    files = gen.write(config, data, root)
    t2 = time.perf_counter()
    for f in files.values():
        fd = os.open(os.path.join(root, f["path"]), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    seconds = {"generate": t1 - t0, "write": t2 - t1, "fsync": time.perf_counter() - t2}
    return Dataset(config, seed, gen, root, files, data, seconds)


def in_memory(config_name: str, seed: int, overrides=None) -> Dataset:
    """The generated columns of a configuration at a seed with no file written:
    enough for the traffic and the reference (the controls' runs)."""
    config, gen = load_config(config_name, overrides)
    data = gen.generate(config, seed)
    files = {k: {"path": k, "rows": len(next(iter(cols.values())))} for k, cols in data.items()}
    return Dataset(config, seed, gen, "", files, data)


def attach(config_name: str, seed: int, overrides, root: str, files: dict) -> Dataset:
    """The files another process of the run wrote for a configuration (the
    `files` that its `build` returned), with no generated column: enough for
    the traffic, which names files and draws its own parameters."""
    config, gen = load_config(config_name, overrides)
    return Dataset(config, seed, gen, root, files, {})
