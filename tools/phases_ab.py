"""Run ``chip_smoke.py``'s ``phase_enforce``, ``phase_coresidency``,
``phase_device_plugin`` and ``phase_quant_serve`` (or the phases
``--phases`` names, of those and ``preempt``) on the card, once for each
checkout given, in turn, each in a process of its own from that
checkout's root (the kernels and libraries built there first).

    python3 tools/phases_ab.py [--phases device_plugin,preempt] \
        LABEL DIR [LABEL DIR ...]

e.g. ``P <parent> C .`` to hold a depth cut in those phases against the
parent within one machine's run (unpack the parent with ``git archive``
into a directory that ``.gitignore`` lists).  The phases run in the
script's order: ``phase_enforce`` before ``phase_coresidency``, which
holds T's losses to its.  Prints one JSON line a run: its exit code and
wall seconds, the card's name and power limit, the build's and each
phase's seconds (None and the error where a phase failed), and, where
the checkout has them, the compaction leg's and the elastic leg's and
the node agent's seconds and the checkpoint saves' and restores' seconds
of the compaction and of ``preempt``.  ``phase_device_plugin`` run without
``phase_coresidency`` ends at its comparison with that phase's readings
(a KeyError), after everything it times: its ``device_plugin_s``, the
phase's own seconds, is then the number to compare.  Writes each run's
output to
``chiprun_out/ab_<LABEL>.log`` and the rows to
``chiprun_out/ab_phases.json``.  Needs one card; the two runs of
``phase_quant_serve`` write ~24 GB to the disk.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

DRIVER = r"""
import json, sys, time, traceback
wanted = sys.argv[1].split(',')
sys.path.insert(0, '.')
import chip_smoke as cs
if hasattr(cs, 'bytecode_cache'):
    cs.bytecode_cache()
import torch
from k8s_vgpu_scheduler_tpu_torch.models import (convert, generate, llama,
                                                 serve, train)
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.monotonic()
built = _kernels.build_all()
driver = _kernels.build_interposer_test()
record = {'card': cs.card_line()}
row = {'card': record['card'], 'build_s': time.monotonic() - t0}
port = (llama, convert, generate, serve, train)
phases = (
    ('enforce', lambda: cs.phase_enforce(torch, record, built['interposer'],
                                         driver)),
    ('coresidency', lambda: cs.phase_coresidency(
        torch, record, built['vgpu'], built['interposer'])),
    ('device_plugin', lambda: cs.phase_device_plugin(torch, record,
                                                     built['vgpu'])),
    ('preempt', lambda: cs.phase_preempt(torch, record, built['vgpu'],
                                         built['interposer'])),
    ('quant_serve', lambda: cs.phase_quant_serve(
        torch, port, record, built['vgpu'], built['interposer'])))
for name, phase in phases:
    if name not in wanted:
        continue
    t = time.monotonic()
    try:
        phase()
        row[name] = time.monotonic() - t
    except BaseException as e:
        row[name] = None
        row[name + '_error'] = repr(e)[:500]
        traceback.print_exc()
    # The phase's own seconds, recorded before its last checks.
    row[name + '_s'] = record.get(name + '_s')
    torch.cuda.empty_cache()
na = record.get('node_agent') or {}
hgx = na.get('hgx') or {}
leg = hgx.get('defrag')
if leg:
    row['leg_s'] = leg['leg_s']
    row['leg_save_s'] = leg.get('save_s')
    row['leg_restore_s'] = leg.get('restore_s')
    row['node_agent_s'] = na.get('run_s')
if hgx.get('elastic'):
    row['elastic_s'] = hgx['elastic']['leg_s']
pre = record.get('preempt_summary')
if pre:
    row['preempt_save_s'] = pre.get('save_s')
    row['preempt_restore_s'] = pre.get('restore_s')
print('AB ' + json.dumps(row), flush=True)
"""

PHASES = "enforce,coresidency,device_plugin,quant_serve"


def main(argv):
    phases = PHASES
    if argv[:1] == ["--phases"]:
        phases, argv = argv[1], argv[2:]
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    rows = []
    for label, tree in zip(argv[0::2], argv[1::2]):
        t0 = time.monotonic()
        res = subprocess.run([sys.executable, "-c", DRIVER, phases],
                             cwd=tree,
                             capture_output=True, text=True, timeout=1500)
        (out / f"ab_{label}.log").write_text(res.stdout + res.stderr)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        row = dict(label=label, rc=res.returncode,
                   wall_s=time.monotonic() - t0,
                   **(json.loads(line[0][3:]) if line else {}))
        rows.append(row)
        print(json.dumps(row), flush=True)
    (out / "ab_phases.json").write_text(json.dumps(rows, indent=1))
    return 0 if rows and all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
