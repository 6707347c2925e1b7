"""What a run leaves behind: its child processes and the modules it loaded.

The harness starts one process of its own, `nvidia-smi`, waited for under
a timeout (subprocess.run kills it when the timeout expires).  Before the
last line a run lists every live child, from multiprocessing's registry
where that module is loaded and from /proc/self/task/*/children, and kills
and reaps any it finds.
"""

from __future__ import annotations

import glob
import os
import signal
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "audfprint_tpu")


def process_age_s() -> float | None:
    """Seconds since this process started (Linux /proc), else None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def children() -> list[int]:
    pids = set()
    mp = sys.modules.get("multiprocessing")
    if mp is not None:
        pids.update(p.pid for p in mp.active_children() if p.pid)
    for path in glob.glob("/proc/self/task/*/children"):
        try:
            with open(path) as f:
                pids.update(int(x) for x in f.read().split())
        except OSError:
            continue
    return sorted(pids)


def describe(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f"{pid}: " + f.read().replace(b"\0", b" ").decode(
                errors="replace").strip()
    except OSError:
        return f"{pid}: (gone)"


def reap(pids: list[int], wait_s: float = 10.0) -> None:
    """SIGKILL each child and wait for it."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + wait_s
    for pid in pids:
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done or time.monotonic() > deadline:
                break
            time.sleep(0.01)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def nvidia_smi(timeout: float = 20.0) -> str:
    """The card's name, power limit, SM clock (now and its maximum) and
    temperature, or why they could not be read."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                            "clocks.sm,clocks.max.sm,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=timeout, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"
    return p.stdout.strip().replace("\n", "; ") or p.stderr.strip()
