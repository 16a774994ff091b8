"""What a new Python process pays before its first kernel on the card.

    python3 tools/process_start.py

Run from the root of a checkout.  Times, each in a process of its own,
``import torch`` and ``import torch, torch._inductor`` (what
torch.profiler imports at its first trace) under the environment as
given, then again with one bytecode cache (``PYTHONPYCACHEPREFIX`` in a
temporary directory, ``PYTHONDONTWRITEBYTECODE`` unset: what
``chip_smoke.bytecode_cache`` gives its children), the first process
filling it; and, with the cache, the full-width ``Llama`` built on the
card and ``torch.nn.utils.skip_init`` of its embedding (the meta-device
path the model no longer takes), each with whether ``torch._dynamo``
came in.  Prints one JSON line, the card's name and power limit
included, and writes it to chiprun_out/process_start.json.  Needs one
card for the last two.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BUILD = r"""
import sys, time
t0 = time.monotonic()
import torch
sys.path.insert(0, '.')
from k8s_vgpu_scheduler_tpu_torch.models import llama
imported = time.monotonic() - t0
torch.zeros(1, device='cuda')
torch.cuda.synchronize()
t0 = time.monotonic()
if sys.argv[1] == 'skip_init':
    torch.nn.utils.skip_init(torch.nn.Embedding, 32000, 4096, device='cuda',
                             dtype=torch.bfloat16)
else:
    llama.Llama(llama.llama_7b(), device='cuda')
torch.cuda.synchronize()
print(imported, time.monotonic() - t0, 'torch._dynamo' in sys.modules)
"""


def timed(code: str, env: dict, *args) -> tuple:
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code, *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, check=True)
    return time.monotonic() - t0, p.stdout.split()


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    plain = dict(os.environ)
    out = {"card": card.strip(),
           "dont_write_bytecode": plain.get("PYTHONDONTWRITEBYTECODE")}
    torch_only, inductor = "import torch", "import torch, torch._inductor"
    out["as_given"] = {
        "import_torch_s": [timed(torch_only, plain)[0] for _ in range(2)],
        "import_torch_inductor_s": [timed(inductor, plain)[0]]}
    cache = tempfile.mkdtemp(prefix="process-start-pyc-")
    try:
        cached = {k: v for k, v in plain.items()
                  if k != "PYTHONDONTWRITEBYTECODE"}
        cached["PYTHONPYCACHEPREFIX"] = cache
        out["cached"] = {
            "filling_s": timed(inductor, cached)[0],
            "import_torch_s": [timed(torch_only, cached)[0]
                               for _ in range(2)],
            "import_torch_inductor_s": [timed(inductor, cached)[0]
                                        for _ in range(2)]}
        for what in ("llama", "skip_init"):
            wall, (imported, built, dynamo) = timed(BUILD, cached, what)
            out["cached"][f"build_{what}"] = dict(
                wall_s=wall, imports_s=float(imported), build_s=float(built),
                imported_dynamo=dynamo == "True")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    line = json.dumps(out)
    print(line)
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    (logs / "process_start.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
