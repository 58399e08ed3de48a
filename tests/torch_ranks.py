"""Run a snippet of the PyTorch port on several gloo ranks on 127.0.0.1.

Used by tests/test_torch_collectives.py and tests/test_torch_multihost.py.
Each rank is a fresh interpreter that initialises the port's
utils/distributed from the EAGLE_* variables, runs the snippet, and saves
its ``OUT`` dict of arrays to an .npz of its own. One deadline covers the
whole job: when it passes, every rank is killed and the test fails, so a
deadlock inside a collective costs one test, never the suite.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import os
import numpy as np
import torch
torch.set_num_threads(1)
from eagleeverything_tpu_torch.utils import distributed
distributed.maybe_initialize()
RANK = distributed.process_index()
WORLD = distributed.process_count()
OUT = {}
"""

EPILOGUE = r"""
np.savez(os.environ["EAGLE_TEST_OUT"], **{k: np.asarray(v)
                                          for k, v in OUT.items()})
distributed.shutdown()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(code: str, world: int, tmp, env: dict | None = None,
          tag: str = "job", port: int | None = None
          ) -> tuple[list[subprocess.Popen], list[str]]:
    """Start ``world`` ranks of ``code`` (PRELUDE + code + EPILOGUE);
    returns the processes and each rank's output path. ``world`` 1 is a
    plain single process, with no group, under the ranks' settings (one
    BLAS thread), so its host f64 results can be held bit for bit to a
    multi-process job's."""
    port = port or free_port()
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(str(tmp), f"{tag}_rank{r}.npz")
        e = dict(os.environ)
        e.pop("EAGLE_COORD_ADDR", None)
        if world > 1:
            e.update(EAGLE_COORD_ADDR=f"127.0.0.1:{port}",
                     EAGLE_NUM_PROCS=str(world), EAGLE_PROC_ID=str(r))
        e.update(EAGLE_TEST_OUT=out, OMP_NUM_THREADS="1",
                 CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
        e.update(env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRELUDE + code + EPILOGUE], env=e,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs.append(out)
    return procs, outs


def kill_all(procs: list[subprocess.Popen]) -> None:
    for pr in procs:
        if pr.poll() is None:
            pr.send_signal(signal.SIGKILL)
    for pr in procs:
        pr.wait()
        if pr.stdout:
            pr.stdout.close()


def wait_all(procs: list[subprocess.Popen], timeout: float) -> list[str]:
    """Each rank's output; fails (after killing every rank) when the job
    outlives ``timeout`` seconds or a rank exits non-zero."""
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for r, pr in enumerate(procs):
            left = max(deadline - time.monotonic(), 0.1)
            try:
                out, _ = pr.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"rank {r} of {len(procs)} still running after "
                    f"{timeout} s: killed the job") from None
            logs.append(out.decode(errors="replace"))
    finally:
        kill_all(procs)
    for r, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"rank {r} exited {pr.returncode}:\n" \
            + log[-4000:]
    return logs


def run_ranks(code: str, world: int, tmp, timeout: float = 120.0,
              env: dict | None = None, tag: str = "job") -> list[dict]:
    """Run ``code`` on ``world`` ranks; each rank's ``OUT`` as a dict."""
    procs, outs = spawn(code, world, tmp, env, tag)
    wait_all(procs, timeout)
    res = []
    for out in outs:
        with np.load(out) as z:
            res.append({k: z[k] for k in z.files})
    return res


def assert_ranks_equal(outs: list[dict]) -> None:
    """Every rank's results bit for bit equal to rank 0's."""
    for r, o in enumerate(outs[1:], start=1):
        assert o.keys() == outs[0].keys()
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k],
                                          err_msg=f"rank {r}: {k}")
