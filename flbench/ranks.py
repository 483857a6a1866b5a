"""Cells of more than one card: one rank a card, the port's own SPMD idiom.

A cell of `chips: n > 1` runs n processes. The one the command starts is
rank 0: it builds the dataset, then starts ranks 1..n-1 as children of the
same checkout (`python3 -m flbench.ranks <arguments as JSON>`, the same
environment and cache directories), and every rank joins through the
program's own API, `parallel.mesh.setup_distributed` then `make_mesh`. Every
call of the traffic gets `mesh=` that mesh. Beside it the ranks share a
gloo group on the host, which carries rank 0's flag before each call (go on
or stop: rank 0 owns the clock, and every rank draws the same calls from
the same seed, so nothing else is sent) and, after the window, each rank's
summary to rank 0.

Nothing hangs: both groups time out after TIMEOUT_S, rank 0 watches its
children and ends the run (exit 4, no result) as soon as one exits before
its summary is in, with the end of that child's output; a child whose rank 0
has gone ends itself.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

#: the longest any collective or rendezvous of a run may wait
TIMEOUT_S = 300
#: the exit code of rank 0 when a child failed
CHILD_FAILED = 4


def free_address() -> str:
    """A TCP address on this host that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return "tcp://127.0.0.1:%d" % s.getsockname()[1]


def rank_device(device: str, r: int) -> str:
    return f"cuda:{r}" if device.startswith("cuda") else device


@contextlib.contextmanager
def _default_timeout(seconds: float):
    """Default groups made inside get `seconds` as their timeout, their
    rendezvous included (setup_distributed takes none)."""
    import torch.distributed.distributed_c10d as c10d

    was = c10d.default_pg_timeout, c10d.default_pg_nccl_timeout
    c10d.default_pg_timeout = c10d.default_pg_nccl_timeout = \
        datetime.timedelta(seconds=seconds)
    try:
        yield
    finally:
        c10d.default_pg_timeout, c10d.default_pg_nccl_timeout = was


class Children:
    """Ranks 1..n-1 as processes, each writing its output to a file of its
    own, watched by a thread of rank 0 until their summaries are in."""

    def __init__(self, argv_of, n: int, log_dir: str, env: dict, cwd: str):
        os.makedirs(log_dir, exist_ok=True)
        self.logs = [os.path.join(log_dir, f"rank{r}.log") for r in range(1, n)]
        self.procs = []
        for r, log in zip(range(1, n), self.logs):
            with open(log, "wb") as out:
                self.procs.append(subprocess.Popen(
                    argv_of(r), cwd=cwd, env=env, stdin=subprocess.DEVNULL, stdout=out,
                    stderr=subprocess.STDOUT))
        self._done, self._lock, self._reported = threading.Event(), threading.Lock(), False
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def tail(self, i: int, nbytes: int = 4000) -> str:
        with open(self.logs[i], "rb") as f:
            f.seek(max(0, os.path.getsize(self.logs[i]) - nbytes))
            return f.read().decode(errors="replace")

    def ended(self, wait: float = 0.0) -> list:
        """The children that have exited, as (rank, exit code), waiting up to
        `wait` seconds for one to."""
        deadline = time.monotonic() + wait
        while True:
            out = [(r, p.poll()) for r, p in enumerate(self.procs, 1) if p.poll() is not None]
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.05)

    def report(self, ended) -> None:
        """Print, once, each child that ended before the run did, with the
        end of its output."""
        with self._lock:
            if self._reported:
                return
            self._reported = True
            for r, code in ended:
                print(f"rank {r} exited with code {code} before the run ended; the end of its "
                      f"output:\n{self.tail(r - 1)}", file=sys.stderr, flush=True)

    def _watcher(self) -> None:
        while not self._done.wait(0.2):
            ended = self.ended()
            if ended and not self._done.is_set():
                self.report(ended)
                self.stop()
                os._exit(CHILD_FAILED)

    def release(self) -> None:
        """Stop watching: every summary is in, the children may end."""
        self._done.set()

    def stop(self) -> None:
        """End every child that is still running, and wait for it."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def wait(self, seconds: float = 120) -> list:
        """The children's exit codes, once each has ended (killed after
        `seconds`)."""
        deadline = time.monotonic() + seconds
        for p in self.procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return [p.returncode for p in self.procs]


class Group:
    """One rank's place in a multi-card run: the program's mesh, the host
    group of the flag and the summaries, and on rank 0 the children."""

    def __init__(self, address: str, n: int, r: int, device: str, children=None):
        import torch
        import torch.distributed as dist

        from fastlanes_tpu_torch.parallel import mesh

        self.n, self.r, self.children = n, r, children
        # the host's cores shared out, as a card of the one-card cells has its
        # machine's: its share of them for a rank's intra-op threads
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
        mine = rank_device(device, r)
        with _default_timeout(TIMEOUT_S):
            mesh.setup_distributed(address, n, r, device=mine)
        self.mesh = mesh.make_mesh(n, device=mine)
        self.host = dist.new_group(backend="gloo",
                                   timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self._flag = torch.zeros(1, dtype=torch.int32)

    @property
    def kwargs(self) -> dict:
        """What every call of the traffic gets beside its own arguments."""
        return {"mesh": self.mesh}

    def go(self, on: bool) -> bool:
        """Rank 0's word before each call, on every rank: go on (True) or
        stop. Only rank 0's `on` counts."""
        import torch.distributed as dist

        self._flag[0] = int(on)
        dist.broadcast(self._flag, src=0, group=self.host)
        return bool(self._flag[0])

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.host)

    def gather(self, summary: dict):
        """Every rank's summary, in rank order, on rank 0 (None elsewhere);
        on rank 0 the children may end after it."""
        import torch.distributed as dist

        got = [None] * self.n if self.r == 0 else None
        dist.gather_object(summary, got, dst=0, group=self.host)
        if self.children is not None:
            self.children.release()
        return got

    def close(self) -> None:
        """Leave both groups; on rank 0 wait for the children, which must end
        well."""
        import torch.distributed as dist

        dist.destroy_process_group(self.host)
        dist.destroy_process_group()
        if self.children is not None:
            codes = self.children.wait()
            bad = {r: c for r, c in enumerate(codes, 1) if c != 0}
            if bad:
                raise RuntimeError(f"ranks ended with codes {bad}")


def start(cell: dict, seed: int, seconds: float, trace: bool, device: str, overrides, ds,
          child_argv=None) -> Group:
    """On rank 0, once its dataset is written: start the other ranks and join
    them. `child_argv` is the command that starts a child, before its one
    argument (`python3 -m flbench.ranks` by default). Each child writes its
    output beside the data, to `_ranks/rank<r>.log`."""
    from .run import CACHE_ENV, ROOT

    n = cell["chips"]
    address = free_address()
    args = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "device": device,
            "overrides": overrides, "root": ds.root, "files": ds.files, "address": address,
            "ranks": n, "parent": os.getpid()}
    prefix = child_argv or [sys.executable, "-m", "flbench.ranks"]
    children = Children(lambda r: prefix + [json.dumps(dict(args, rank=r))], n,
                        os.path.join(os.path.dirname(ds.root), "_ranks"),
                        {**os.environ, **CACHE_ENV}, ROOT)
    try:
        return Group(address, n, 0, device, children)
    except BaseException:
        children.stop()
        raise


@contextlib.contextmanager
def guarded(group):
    """Rank 0's run on `group` (None: a run of one card, left as it is): a
    failure that follows a child's exit ends the run with CHILD_FAILED and
    that child's output; every child is stopped at the end."""
    if group is None:
        yield
        return
    try:
        yield
    except Exception:
        ended = group.children.ended(wait=2.0)
        if not ended:
            raise
        traceback.print_exc(file=sys.stderr)  # what rank 0 met: a peer gone
        group.children.report(ended)
        raise SystemExit(CHILD_FAILED) from None
    finally:
        group.children.stop()


def digest(calls) -> str:
    """What identifies the calls a rank issued, in order."""
    h = hashlib.sha1()
    for call in calls:
        h.update(repr((call.label, sorted(call.kwargs.items()))).encode())
    return h.hexdigest()


def summary(record, issued, trace, peak: int, forbidden) -> dict:
    """What a rank tells rank 0 after the window."""
    from .spans import self_ms_by_name

    return {"calls": record.calls, "failed": record.failed, "digest": digest(issued),
            "memory_peak_bytes": int(peak), "forbidden": forbidden,
            "busy_s": trace.busy_s() if trace is not None else None,
            "self_ms": self_ms_by_name(trace) if trace is not None else None}


def report(s: dict) -> dict:
    """What the result line keeps of a rank's summary."""
    out = {k: s[k] for k in ("calls", "failed", "memory_peak_bytes", "forbidden")}
    if s["self_ms"] is not None:
        calls = max(1, s["calls"])
        out["busy_s"] = s["busy_s"]
        out["host_ms_per_call"] = sum(
            ms for name, ms in s["self_ms"].items() if name != "combine") / calls
        out["self_ms_per_call"] = {name: ms / calls for name, ms in sorted(s["self_ms"].items())}
    return out


def _watch_parent(pid: int) -> None:
    """End this process once rank 0 (its parent) has gone."""
    def watch():
        while os.getppid() == pid:
            time.sleep(0.5)
        os._exit(5)
    threading.Thread(target=watch, daemon=True).start()


def child_main(argv=None) -> int:
    """Rank r of a multi-card run: join, warm up, follow rank 0's flag through
    the window, send its summary."""
    import torch

    from . import dataset, run, traffic

    a = json.loads((sys.argv[1:] if argv is None else argv)[0])
    _watch_parent(a["parent"])
    cell, device, seed = a["cell"], a["device"], a["seed"]
    ds = dataset.attach(cell["config"], seed, a["overrides"], a["root"], a["files"])
    spec = traffic.load(cell["traffic"])
    fn = run._program_entry(spec["entry"])
    group = Group(a["address"], a["ranks"], a["rank"], device)
    run.warm(fn, spec, ds, seed, device, group)
    record = run.Record()
    calls = traffic.Traffic(spec, ds, seed, stream=1).calls()
    issued, prof = run.measure(fn, calls, a["seconds"], device,
                               run.Sample(0, dataset.rng_of(seed, 2)), lambda call: 0, record,
                               a["trace"], group)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    tr = None
    if prof is not None:
        from .trace import collect
        tr = collect(prof)
        del prof
    group.gather(summary(record, issued, tr, peak, run.loaded_forbidden()))
    group.close()
    return 0


if __name__ == "__main__":
    sys.exit(child_main())
