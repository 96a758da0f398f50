"""Launching the port's data-parallel test workers: W processes on this
machine, gloo on 127.0.0.1 at a free port, each with its own timeout and
killed in a `finally`.  No JAX here: the workers import this module, and
a worker imports neither jax nor the JAX package.

A worker is a test file run as a script (`python tests/<file>.py <args>`,
its `if __name__ == "__main__"` block); it joins the group through
`srfdet3d_torch.parallel.init_from_env` from the RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT set here.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, args: Sequence[str], world: int = 2,
              timeout: float = 120.0) -> List[Tuple[int, str]]:
    """Run `python <script> <args>` as ranks 0..world-1 of one gloo group
    (one intra-op thread each); returns each rank's (exit code, output).
    A rank still running after `timeout` seconds from the start is killed
    and reports exit code None.  Launched once more, on a new port, when
    another process took the free port first."""
    out = _run_ranks(script, args, world, timeout)
    if any("address already in use" in text.lower() for _, text in out):
        out = _run_ranks(script, args, world, timeout)
    return out


def _run_ranks(script, args, world, timeout):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               SRFDET_DIST_BACKEND="gloo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, script, *args],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode if p.returncode is not None and
                    p.returncode >= 0 else None, log.read()))
        log.close()
    return out


def check_ranks(results: List[Tuple[int, str]]) -> None:
    """Every rank exited 0 (else the failing rank's output)."""
    for r, (code, text) in enumerate(results):
        assert code == 0, f"rank {r} exited {code}:\n{text[-4000:]}"


def worker_setup():
    """A worker's start: one intra-op thread, the group joined on the CPU;
    returns (rank, world)."""
    import torch
    torch.set_num_threads(1)
    from srfdet3d_torch.parallel import mesh
    assert mesh.init_from_env(torch.device("cpu"))
    return mesh.rank(), mesh.world()


def worker_finish():
    """A worker's end: leave the group, and hold that no JAX was
    imported."""
    from srfdet3d_torch.parallel import mesh
    mesh.shutdown()
    bad = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "srfdet3d_tpu"))]
    assert not bad, f"a worker imported {bad[:3]}"
