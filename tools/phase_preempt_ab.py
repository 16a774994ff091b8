"""Run ``chip_smoke.py``'s ``phase_preempt`` alone on the card, once for
each checkout given, in turn, each in a process of its own from that
checkout's root (the kernels it needs built there first).

    python3 tools/phase_preempt_ab.py LABEL DIR [LABEL DIR ...]

e.g. ``P1 <parent> C1 . C2 . P2 <parent>`` to hold two commits to each
other within one machine's run (unpack the parent with ``git archive``
into a directory that ``.gitignore`` lists).  Prints one JSON line a
run: its exit code and wall seconds, the phase's seconds, the step V
stopped at, ``PREEMPT_STEPS``, each pod's seconds, the card's name and
power limit, and the fleet view's command seconds and simulator legs
where the checkout has them; writes each run's output to
``chiprun_out/ab_<LABEL>.log`` and the rows to
``chiprun_out/preempt_ab.json``.  Needs one card.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

DRIVER = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, '.')
import chip_smoke as cs
import torch
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
with ThreadPoolExecutor(8) as pool:
    vgpu = pool.submit(_kernels.build_vgpu)
    interposer = pool.submit(_kernels.build_interposer)
    list(pool.map(_kernels.build, cs.KERNEL_SOURCES))
    vgpu, interposer = vgpu.result(), interposer.result()
record = {'card': cs.card_line()}
cs.phase_preempt(torch, record, vgpu, interposer)
s = record['preempt_summary']
print('AB ' + json.dumps({'seconds': s['seconds'],
    'k': s['preempted_at_step'], 'steps': cs.PREEMPT_STEPS,
    'child_s': s['child_s'], 'save_s': s['save_s'],
    'restore_s': s['restore_s'], 'card': record['card'],
    'fleet_view': {k: s['fleet_view'].get(k) for k in (
        'vgpu_report_s', 'vgpu_smi_top_s', 'fleetz', 'simulate_live',
        'simulate_scale')}}), flush=True)
"""


def main(argv):
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    rows = []
    for label, tree in zip(argv[0::2], argv[1::2]):
        t0 = time.monotonic()
        res = subprocess.run([sys.executable, "-c", DRIVER], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        (out / f"ab_{label}.log").write_text(res.stdout + res.stderr)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        row = dict(label=label, rc=res.returncode,
                   wall_s=time.monotonic() - t0,
                   **(json.loads(line[0][3:]) if line else {}))
        rows.append(row)
        print(json.dumps(row), flush=True)
    (out / "preempt_ab.json").write_text(json.dumps(rows, indent=1))
    return 0 if rows and all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
