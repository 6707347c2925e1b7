"""No process outlives a run: the harness starts none of its own but a
waited nvidia-smi, and its exit check finds, kills and reports a child."""

import ast
import json
import os
import subprocess
import sys
import time

from portbench import procs, run

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)

BANNED = ("multiprocessing", "concurrent.futures", "subprocess", "os.fork",
          "os.spawn", "os.system", "os.popen", "pty", "ProcessPool")


def _harness_files():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_harness_starts_no_process():
    for path in _harness_files():
        with open(path) as f:
            src = f.read()
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    if m and m.split(".")[0] in ("multiprocessing",
                                                 "concurrent", "pty"):
                        raise AssertionError(f"{path} imports {m}")
                    if m == "subprocess":
                        assert path.endswith("procs.py"), path
        for word in ("os.fork", "os.spawn", "os.system", "os.popen",
                     "ProcessPool", "Popen"):
            assert word not in src, (path, word)
    with open(os.path.join(PKG, "procs.py")) as f:
        src = f.read()
    # the one process: nvidia-smi, under a timeout subprocess.run enforces
    assert src.count("subprocess.run(") == 1 and "timeout=timeout" in src


def test_exit_check_finds_kills_and_reaps_a_child():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        time.sleep(0.2)
        assert child.pid in procs.children()
        assert "sleep" in procs.describe(child.pid)
        procs.reap([child.pid])
        assert child.pid not in procs.children()
        assert child.poll() is not None or not os.path.exists(
            f"/proc/{child.pid}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)


def test_main_reports_a_stray_child_as_failed(monkeypatch, capsys):
    started = []

    def fake_cell(files, seed, seconds, traced, device, tmp, t0):
        started.append(subprocess.Popen([sys.executable, "-c",
                                         "import time; time.sleep(60)"]))
        return {"correct": True, "attempted": 1, "failed": 0,
                "metrics": {}, "device": {}, "checks": {}}

    monkeypatch.setattr(run, "check_chip", lambda chips: None)
    monkeypatch.setattr(run, "run_cell", fake_cell)
    monkeypatch.setattr(procs, "nvidia_smi", lambda timeout=20.0: "none")
    try:
        rc = run.main(["--workload", "c2-1k.ingest", "--seed", "5",
                       "--seconds", "1"])
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert rc == 1 and not line["correct"] and line["failed"] == 1
        assert "processes left running" in err
        assert started[0].poll() is not None
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "check_chip", lambda chips: "no CUDA device")
    rc = run.main(["--workload", "c2-1k.ingest", "--seed", "5",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no result" in err


def test_only_the_benchmark_files_is_no_result(tmp_path):
    """A checkout with BENCHMARK.json and portbench/ alone cannot run."""
    import shutil
    root = os.path.dirname(PKG)
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "c2-1k.ingest", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_process_age_is_read():
    age = procs.process_age_s()
    assert age is None or 0 <= age < 24 * 3600
