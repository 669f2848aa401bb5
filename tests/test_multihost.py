"""Multi-process runtime: 2 CPU processes x 4 virtual devices form one
8-device global mesh; cross-process psum and distributed BA must agree
on both ranks (the multi-host code path of SURVEY.md section 5,
exercised single-machine)."""

import os
import re
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


pytestmark = pytest.mark.cpu_only  # needs the 8-device virtual CPU mesh


def test_two_process_mesh_psum_and_ba():
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.update({
            "SURF_COORDINATOR": f"127.0.0.1:{port}",
            "SURF_NUM_PROCESSES": "2",
            "SURF_PROCESS_ID": str(rank),
        })
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    costs = []
    for rank, out in enumerate(outs):
        m = re.search(rf"RANK{rank} OK psum=([\d.]+) ba_cost=([\d.eE+-]+)",
                      out)
        assert m, f"rank {rank} output:\n{out}"
        costs.append(float(m.group(2)))
    # the replicated camera solve must agree bit-for-bit across hosts
    assert costs[0] == costs[1]
