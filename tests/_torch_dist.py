"""Run port code in a fresh interpreter: ``init_process_group`` (gloo, fake) is
global to a process, and pytest-xdist runs other test files in the same
worker, so every multi-rank test runs its ranks in a subprocess."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_py(code: str, timeout: float = 120, env: dict | None = None) -> str:
    """Run ``code`` with the repository's ``src`` on the path; return stdout
    (the test fails with the child's output if it exits nonzero)."""
    full = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
            **(env or {})}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout, env=full, cwd=str(ROOT))
    assert out.returncode == 0, f"STDOUT:\n{out.stdout[-3000:]}\nSTDERR:\n{out.stderr[-5000:]}"
    return out.stdout


def last_json(stdout: str):
    import json

    lines = [ln for ln in stdout.splitlines() if ln.startswith("{") or ln.startswith("[")]
    return json.loads(lines[-1])


def run_ranks(code: str, nprocs: int, timeout: float = 120) -> list[str]:
    """Run ``code`` in ``nprocs`` processes at once, each with ``RANK``,
    ``WORLD`` and ``STORE`` (a ``FileStore`` path) in its globals; return each
    one's stdout (the test fails with the output of any that exits nonzero)."""
    import tempfile
    import time

    tmp = tempfile.mkdtemp()
    script = os.path.join(tmp, "ranks.py")
    with open(script, "w") as f:
        f.write("import sys\n"
                "RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]\n")
        f.write(textwrap.dedent(code))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(nprocs), store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT)) for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"STDOUT:\n{out[-3000:]}\nSTDERR:\n{err[-5000:]}"
    return [out for _, out, _ in outs]
