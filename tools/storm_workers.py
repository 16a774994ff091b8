"""Time ``chip_smoke.py``'s Filter storm (``storm_run``: the port's
extender over HTTP on a FakeKube holding SIM_SCALE's fleet of 128 nodes of
eight H100s, SIM_FLEET's 968 pods from eight submitter threads, a churn
thread resubmitting every tenth bound pod) in three modes, on an
otherwise idle host:

- ``pool``: the default, the candidate-evaluation pool at its automatic
  size (``--filter-workers 0``, min(8, CPU count) threads);
- ``inline``: ``--filter-workers 1``, every fit in the calling thread;
- ``serial``: ``--serial-filter``.

    python3 tools/storm_workers.py [ROUNDS]

Each round runs the three modes once, the order reversed in every other
round, each in a process of its own (a fresh observatory, no pool
threads left over).  The storm's own checks hold in every run (no card
past a total, every decision written, every pod placed or refused with a
reason).  Prints one JSON line a run and a last line with the card's
name and power limit, the host's CPU count and each mode's median
decisions/s; writes every run to ``chiprun_out/storm_workers.json``.
``FILTER_STORM=rehearsal`` storms the small fleet the CPU tests use.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = {"pool": ("optimistic", []),
         "inline": ("optimistic", ["--filter-workers", "1"]),
         "serial": ("serial", ["--serial-filter"])}
KEEP = ("wall_s", "filters", "binds", "placed", "refused",
        "decisions_per_s", "commit_conflicts", "serial_fallbacks",
        "opt_evaluate", "opt_commit", "worker_pool_size",
        "workers_busy_peak", "decision_writer")

CHILD = r"""
import json, sys
sys.path.insert(0, '.')
import chip_smoke as cs
mode, flags = sys.argv[1], json.loads(sys.argv[2])
print(json.dumps(cs.storm_run(mode, flags)))
"""


def run(label: str) -> dict:
    mode, flags = MODES[label]
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", CHILD, mode,
                          json.dumps(flags)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise SystemExit(f"{label}: exit {res.returncode}\n{res.stderr}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    row = {"mode": label, "process_s": time.monotonic() - t0,
           **{k: got[k] for k in KEEP}}
    print(json.dumps(row), flush=True)
    return row


def card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main(argv) -> int:
    rounds = int(argv[0]) if argv else 3
    order = list(MODES)
    rows = []
    for r in range(rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            rows.append(run(label))
    summary = {"card": card(), "cpu_count": os.cpu_count(),
               "rounds": rounds,
               "median_decisions_per_s": {
                   label: statistics.median(
                       x["decisions_per_s"] for x in rows
                       if x["mode"] == label) for label in MODES}}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "storm_workers.json").write_text(
        json.dumps({"summary": summary, "runs": rows}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
