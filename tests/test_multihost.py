"""Multi-host (multi-controller) validation on a 2-process CPU cluster.

The reference is strictly single-device (SURVEY.md §2.3); the north-star
spec requires scaling to >=2 hosts. Several hosts are not available
here, so this spawns TWO separate processes, each with 4 virtual CPU
devices, joined through ``jax.distributed`` (the same gRPC coordination
service a multi-host GPU cluster uses), and runs
``distributed_cg`` on the global 8-device mesh — exercising
``initialize_multihost`` (dist/mesh.py), cross-process device_put
sharding (dist/partition.py), and the gspmd + halo SpMV paths end to
end, not just single-process simulation.
"""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "bench_tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_cg():
    port = _free_port()
    env = dict(os.environ)
    # the workers set their own device count; drop the suite's 8-device
    # forcing and any stale distributed state
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    reports = []
    for out, err in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert lines, f"no JSON from worker:\n{out}\n{err[-1000:]}"
        reports.append(json.loads(lines[-1]))

    by_pid = {r["process_id"]: r for r in reports}
    assert set(by_pid) == {0, 1}
    for r in reports:
        assert r["global_devices"] == 8
        assert r["local_devices"] == 4
        for mode in ("gspmd", "halo", "amg_pcg", "general_csr"):
            stats = r["results"][mode]
            assert stats["info"] == 0, (mode, stats)
            assert stats["rel_residual"] < 1e-5, (mode, stats)
    # the general-CSR system must get the cut-volume halo SpMV across
    # processes (plan built from the pre-shard host copy)
    for r in reports:
        assert r["results"]["general_csr"]["resolved_mode"] == "cwell_halo"
    # AMG must actually precondition (fewer iterations than plain CG)
    assert (by_pid[0]["results"]["amg_pcg"]["iters"]
            < by_pid[0]["results"]["gspmd"]["iters"])
    # both controllers must see the SAME solution, bitwise
    for mode in ("gspmd", "halo", "amg_pcg", "general_csr"):
        crc0 = by_pid[0]["results"][mode]["x_crc"]
        crc1 = by_pid[1]["results"][mode]["x_crc"]
        assert crc0 == crc1, f"cross-process mismatch in {mode}"
    # iteration counts agree across modes (same reduction structure)
    it_g = by_pid[0]["results"]["gspmd"]["iters"]
    it_h = by_pid[0]["results"]["halo"]["iters"]
    assert abs(it_g - it_h) <= 2, (it_g, it_h)
    assert np.isfinite(by_pid[0]["results"]["gspmd"]["rel_residual"])


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
