"""Spawning the port's ranks for the parallel tests: one process a rank,
over gloo on a free local port, with a timeout that kills the children
(as ``tests/test_multiprocess.py`` spawns the JAX package's)."""

import json
import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` worker processes running ``cases`` (saved to ``tmpdir``),
    started at construction; ``results()`` waits for them and returns each
    rank's JSON, or raises with the failing rank's output."""

    def __init__(self, world: int, cases: list, tmpdir: str, timeout: float = 240.0):
        self.world, self.timeout = world, timeout
        case_file = os.path.join(tmpdir, f"cases_{world}.pt")
        torch.save(cases, case_file)
        self.outs = [os.path.join(tmpdir, f"rank{r}_of_{world}.json") for r in range(world)]
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("XLA_FLAGS", None)
        port = str(free_port())
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), port, case_file, self.outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(world)]
        self._results = None

    def results(self) -> list:
        if self._results is not None:
            return self._results
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=self.timeout)
                logs.append(out)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0 or f"WORKER_OK rank={r}" not in log:
                raise AssertionError(f"rank {r} of {self.world} failed:\n{log[-4000:]}")
        self._results = []
        for path in self.outs:
            with open(path) as f:
                self._results.append(json.load(f))
        return self._results
