"""audfprint_torch/parallel/multihost.py across a real process boundary:
torch.distributed processes over gloo on the CPU (localhost), each with
its own logical shards, forming one 8-shard mesh as 2 x 4 and as 4 x 2
(the shapes of tests/test_multihost.py).  The worker
(tests/torch_multihost_worker.py) holds the sharded store, the histogram
core's summed partials, the Matcher's hit exchange and the routed fused
ingest against the host store, the numpy oracle and the single-device
rows, bit for bit.  Every process has its own timeout and is killed if it
outlives it."""

import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(nproc: int, nloc: int, timeout: int = 300) -> list:
    """Start the nproc workers; returns [(returncode, output)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), str(nproc), str(port), str(nloc)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("nproc,nloc", [(2, 4), (4, 2)])
def test_multiprocess_gloo_store_match_ingest(nproc, nloc):
    """2 processes x 4 shards and 4 x 2: every rank's checks pass."""
    for i, (rc, out) in enumerate(run_workers(nproc, nloc)):
        assert rc == 0, f"proc {i} rc={rc}:\n{out[-4000:]}"
        assert f"MULTIHOST_OK proc={i} shards=8" in out, out[-4000:]


def test_a_failing_rank_fails_the_run():
    """A rank that cannot join (one process of a declared two) times out
    and exits non-zero instead of hanging."""
    port = _free_port()
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from audfprint_torch.parallel import multihost\n"
        "multihost.initialize('localhost:%d', 2, 1, 'gloo', timeout_s=5)\n"
        % (ROOT, port))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
