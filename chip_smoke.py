#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from the
sources in the checkout (``_kernels.build_all``, as the image's build
stage does: one nvcc per source, all at once; the tensor-core kernels
must not spill), holds each to its plain PyTorch
version on the card (f32 through the scalar kernels, bf16 through the
tensor-core ones), and drives the
flagship Llama at llama_7b widths (random weights from a seed) down both
of the port's paths: serving (f32 and bf16 flash-vs-full logits, the
full-sequence flash forward, KV-cache generate and the slot-pool
ServingEngine) and training (f32 flash-vs-full parity of loss, grads and
a 4-step trajectory, then an 8-layer bf16 train step with an f32 master
copy, on the card and with the optimizer state offloaded to pinned host
memory).  It checks the outputs and traces the forward, a window of
decode dispatches and one train step with torch.profiler (device busy
share, top kernels, calls of each of the port's kernels).  Then the
enforcement layer (phase_enforce), each part in a child process of this
script (``--enforce-child <name>``) with its own grant env and region:
the card's inventory and a 24000 MiB memory cap under the 32-layer
forward, the 8-layer train step uncapped (its AdamW state through host
swap), then under a 30% compute grant beside an 8000 MiB grant the
weights cannot fit; then the same grants through the CUDA driver-API
interposer (``LD_PRELOAD``, the Python shim standing down): the 24000 MiB
cap with the context counted, two processes of one pod on one grant, a
process that imports only torch, and the train step without the
interposer, through it uncapped and through it at 30%.  Then two pods
share the card under the port's node monitor (phase_coresidency, children
``--enforce-child cores_serve|cores_train``, the monitor's loop in a
thread, no ``force``): a serving pod (priority 0) and the train step
(priority 1), 50% of the card each, in a flat leg (the priority switch)
and a tiered one (latency-critical and best-effort), after the serving
pod alone without and with the interposer.  Then the port's node agent
(phase_device_plugin): the device plugin in a child that never imports
torch (``--enforce-child node_agent``) lists the card through NVML, which
makes no CUDA context, and answers Allocate for the serving and the
training pod as a scheduler bound them; it reads the card's fabric from
NVML's NVLink P2P matrix, answers kubelet's GetPreferredAllocation, and
two agents on the mock NVML (``--enforce-child mock_agent``) add an
eight-card NVSwitch node on which the scheduler places slice and mesh
pods on ring-adjacent cards, and a four-card PCIe node on which it
refuses guaranteed and mesh pods; the card's MIG mode is read from NVML
beside nvidia-smi's (never changed), and a mock MIG node runs the agent's
entry point under ``--partition-strategy mixed``, serving its MIG devices
to this script as kubelet; the port's chart, charts/vgpu, is rendered and
its extender, device plugin and monitor started as processes from the
rendered command lines (chart_leg: the agent must register the card
through NVML with the chart's extender, install the interposer, and
register with this script as kubelet; the webhook and Filter must answer
at the chart's paths, every family the chart's dashboards name must be
scraped, and each daemon must stop on SIGTERM); the two pods then run one flat
leg of the co-residency phase with the env a kubelet builds from those
answers and nothing else, while the node's observability surface
(``cmd/monitor.py``'s ``serve`` over that leg's monitor loop: the
exporter, NodeTPUInfo and ``/debug``; ``NodeView``) is read three times
against both pods' regions and ``vgpu-smi`` runs under T's grant env
alone, and a process started from a bundle that
``vgpu-oci-runtime`` injected is held to its grant.  Then the pod's life cycle:
checkpoint-first eviction from the scheduler's own plan (phase_preempt:
the control plane up for the whole phase in a child without torch,
``--enforce-child control_plane``, with preemption on; the pods
``--enforce-child preempt|preempt_swap`` under the env of their Allocate
answers): a training pod placed by the extender is asked by the
scheduler to leave for a high-priority pod that fits nowhere,
checkpoints at the next step boundary and exits; the high-priority pod
is placed in its room and spills its AdamW state to the host through the
shim the startup hook installed as it imported its port; the trainer, rescheduled, finishes bit
for bit as an uninterrupted run; ``vgpu-monitor`` itself, as a process
over the placed pods' regions, feeds their usage counters through
NodeTPUInfo and the register stream into the extender's ledger, which
its exporter, ``/usagez``, ``/debug/tracez``, ``vgpu-report`` and
``vgpu-smi top`` must show as the monitor counted them (``FleetView``),
while the capacity simulator ``vgpu-simulate`` replays the extender's
``/fleetz`` (a pod of the card's remaining MiB fits, one of a MiB more
pends) and a 968-pod job mix on 128 nodes of eight H100s (no card
overbooked, metering within 5%, the idle pods named);
then the node's lease expires and the
rescuer rescinds what is left on it; and the serving
pod's own entry point (phase_quant_serve, ``python -m
k8s_vgpu_scheduler_tpu_torch.cmd.serve``) restores the 32-layer model
from a checkpoint, quantizes it to int8 under an 8000 MiB grant its bf16
weights cannot fit (and to int4 under 5000 MiB) and serves the main
path's requests over HTTP with the tokens of an in-process engine, then
drains on SIGTERM.  Last, the reference's ten benchmark cases
(phase_workloads: ResNet-V2-50/152, VGG-16, DeepLab-v3 and the LSTM,
inference and training at bench.py's shapes): all ten on bare metal in
one child (``--enforce-child workloads_bare``), then each as a pod
through the interposer under its memory grant (``--enforce-child
workload:<case>``), each held to the f32 path of its weights, its grant
and its region.  Exits non-zero if any phase fails, and at once
(printing no result) without a CUDA device or outside a checkout.

Stdout ends with: the enforcement phase's ``{"phase": "enforce", ...}``
line, the co-residency phase's ``{"phase": "coresidency", ...}`` line,
the ``{"phase": "device_plugin", ...}`` line (NVML's fields, every
memory size read, the fabric's answers and placements with their times,
and ``node_view``: each reading's scrape and RPC seconds, bytes,
families and samples, the switches, vgpu-smi's view and seconds),
the ``{"phase": "preempt", ...}`` (with ``fleet_view``: both scrapes,
the ledger's rows, the phase counts, V's trace, each command's seconds,
``/fleetz`` and the simulator's replays)
and ``{"phase": "quant_serve", ...}`` lines, the ``{"phase": "workloads", ...}`` line and a ``{"workloads":
[...]}`` line (one row a case: images/s in both legs and their ratio, the
grant and peaks, MFU, the bf16 error), each phase's seconds, a
``{"kernels": [...]}`` line (per kernel: launches on the main
paths, max error, kernel / plain / library times and the card's bound),
the card's name and power limit from nvidia-smi, and the line
``{"ok": true, "device": {...}}``.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# without tensor cores (the kernel keeps f32 out of TF32), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the forward kernels against the plain version on the same
# inputs.  f32 (the scalar kernel): two f32 softmax orders, O's max abs
# error.  lse is f32 in both dtypes.
TOL_O = 1e-4
TOL_LSE = {"float32": 1e-4, "bfloat16": 1e-3}
# bf16 (the tensor-core kernel), O on its own scale (see grad_errors):
# - max|got - want| / max|want| at most 2**-7 + 2**-8 max|V| / max|want|,
#   derived: rounding P to bf16 moves each weight by at most 2**-8 of
#   itself, so O (a convex sum of V's rows) by at most 2**-8 max|V|; both
#   sides round O to bf16, each by at most 2**-8 of max|O|;
# - relative RMS of the whole O and of its worst (batch, 64-row tile,
#   head) block: 4x the largest reading over all cases on an H100 80GB
#   HBM3 (2.28e-3 and 2.80e-3; max error read 4.85e-3 of max|O|).
TOL_O_BF16_RMS = 9.2e-3
TOL_O_BF16_TILE = 1.12e-2
# f32 logits of 2 llama_7b-width layers, flash kernel vs plain full
# attention: both exact f32; ~1e-5 expected, 1e-3 allowed.
TOL_FLASH_VS_FULL = 1e-3
# bf16 logits of 2 llama_7b-width layers on (1, 2048) tokens, flash kernel
# vs plain full attention (which rounds its logits and P to bf16
# elsewhere): relative RMS, 4x the reading on an H100 80GB HBM3 (1.24e-2).
TOL_BF16_FLASH_VS_FULL = 5e-2
# Backward kernels against the plain backward on the same (q, k, v, dO,
# lse, Δ), each output (dQ, dK, dV) on its own scale (judge_backward):
# - max|got - want| / max|want|.  f32 (the scalar kernels): two f32
#   summation orders, TOL_GRAD.  bf16 (the tensor-core kernels, which
#   round P and dS to bf16 before their products): derived from that
#   rounding in grad_max_limits;
# - the relative RMS error ||got - want|| / ||want|| of the whole output,
#   and the worst one of its (batch, 64-row tile, head) blocks, which a
#   dropped or misweighted tile moves where the largest element hides it;
# - with causal window 1, dQ and dK are zero by the mathematics (P is 1 on
#   the diagonal, so dS = dP - Δ = 0): both sides must stay under an
#   absolute limit instead.
# The RMS and zero limits are 4x the largest reading over all cases on an
# H100 80GB HBM3 (RMS f32 6.06e-7, bf16 2.84e-3; worst block f32
# 1.40e-6, bf16 3.91e-3; zero outputs 8.16e-6).  The bf16 readings are
# the tensor-core kernels' (P and dS rounded to bf16); the plain torch
# emulation of that rounding in tests/test_torch_flash_backward.py reads
# 2.82e-3 and 3.88e-3 on its CPU cases.
TOL_GRAD = 1e-4
TOL_GRAD_RMS = {"float32": 2.5e-6, "bfloat16": 1.14e-2}
TOL_GRAD_TILE = {"float32": 5.7e-6, "bfloat16": 1.57e-2}
TOL_GRAD_ZERO = 3.3e-5
GRAD_TILE = 64
# Training at llama_7b widths in f32, flash kernels vs plain full
# attention: loss relative; each grad against its own largest |value|.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
# The bf16 main path at 8 layers, flash kernels vs plain full attention on
# the same weights and batch: step-0 loss relative, and each param grad's
# relative RMS difference.  Both sides round differently in bf16, so the
# limits are 4x the reading on an H100 80GB HBM3 (loss 4.57e-5, worst
# grad 3.20e-2).  The loss reading moved from 1.82e-5 when the bf16
# forward began to round P to bf16 before PV (the tensor-core kernel), so
# its limit moved with it, from 7.3e-5.
TOL_BF16_LOSS = 1.9e-4
TOL_BF16_GRAD_RMS = 0.13
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# Device time of a profile summed by kernel family (name substrings): the
# port's kernels (one name each: every __global__ under csrc/), cuBLAS
# products, and everything else (elementwise, reductions, copies).
KERNEL_GROUPS = {"port_kernels": ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                                  "flash_bwd_dq_mma_kernel",
                                  "flash_bwd_dkv_mma_kernel",
                                  "flash_bwd_dq_kernel",
                                  "flash_bwd_dkv_kernel"),
                 "matmul": ("nvjet", "gemm", "cutlass", "sm90_xmma")}
# The enforcement phase (phase_enforce): a 24000 MiB grant for the 32-layer
# forward (13.5 GB of bf16 weights) and one the weights cannot fit; 256 MiB
# blocks up to the grant, whose refusal must come within 2 blocks of it;
# the region's published use within 5% of the allocator's reserved bytes;
# a 30% compute grant whose duty must land within 10 points of it (the
# bound of tests/test_shim.py's duty check), an uncapped duty above 85%;
# each step's charged cost within 10% of its device time; the swapped
# AdamW state's bytes freed within 1%.
MIB = 1 << 20
ENFORCE_LIMIT_MIB = 24000
ENFORCE_SMALL_LIMIT_MIB = 8000
ENFORCE_BLOCK = 256 * MIB
ENFORCE_SM_LIMIT = 30
TOL_DUTY_POINTS = 0.10
MIN_UNCAPPED_DUTY = 0.85
TOL_CHARGED = 0.10
TOL_USED = 0.05
TOL_SWAP_BYTES = 0.01
# Under the interposer (child_interposer_swap): the charge taken 256 MiB
# past the spiller's pressure point, and 3 steps after the swap.
SWAP_OVER_MIB = 256
INTERPOSER_SWAP_STEPS = 3
# The interposer's children: 256 MiB blocks up to the grant, which
# nvidia-smi's reading (the card's used memory less what it held before,
# contexts included) must not pass and must come within 512 MiB of, for
# one process, for a pod's two and for a process that imports only torch;
# the same 5% between the region's `used` and that reading; the fixed
# context charge at most 64 MiB above what the card shows outside the
# allocations, and never below it; INTERPOSER_STEPS_TRACED train steps
# traced for their device time after the 8 timed ones; AB_PAIRS pairs of train children without
# and with the interposer, uncapped, for its end-to-end cost; the C
# driver's null kernel launched NULL_LAUNCHES times each way for its host
# cost a launch; a co-tenant outside the pod allocating and freeing 1 GiB
# blocks while the pod's contexts come up.  Two traced steps, not three:
# the script's time goes to the observability legs.
INTERPOSER_STEPS_TRACED = 2
TOL_GRANT_MIB = 512
TOL_CONTEXT_MIB = 64
AB_PAIRS = 2
NULL_LAUNCHES = 20000
COTENANT_BLOCK = 1024 * MIB
# The main path's serving traffic: 6 requests of these prompt lengths, 32
# new tokens each, on a 4-slot engine.
SERVE_LENS = (64, 128, 200, 333, 512, 96)
SERVE_NEW = 32
SERVE_SLOTS = 4
# Speculative decoding (models/generate.py speculative_generate), k draft
# tokens a round: in f32 on the 2-layer model, a 1-layer early-exit draft
# and a random 1-layer draft, SPEC_F32_NEW tokens on a SPEC_F32_PROMPT-
# token prompt, each token-identical to generate(); in bf16 on the
# 32-layer model, a SPEC_DRAFT_LAYERS-layer early-exit draft, SPEC_NEW
# tokens on a SPEC_PROMPT-token prompt, timed against generate() (median
# of SPEC_TIMED runs each).  bf16 argmax may break near-ties differently
# in the 1-token and the (k + 1)-token forwards, so there the first
# position where the two differ is recorded, not held.
SPEC_K = 4
SPEC_F32_PROMPT, SPEC_F32_NEW = 128, 32
SPEC_PROMPT, SPEC_NEW = 512, 64
SPEC_DRAFT_LAYERS = 2
SPEC_TIMED = 3
# The co-residency phase (phase_coresidency): a serving pod (priority 0)
# and a training pod (priority 1) on one card, each asking
# nvidia.com/gpucores: 50 (the lab's own split, shim/simlab.py's
# drive_serving), under the port's node monitor ticking every 0.5 s (the
# lab's monitor_interval_s).  The parent reads every region every 0.1 s.
# The switch must turn on within 2 ticks of the serving pod's first
# prefill and off within 5 ticks of its last launch (recent_kernel is set
# to 3 and aged 1 a tick), each reading late by up to one timeline period;
# T's duty while its switch is on must land within TOL_DUTY_POINTS of 50%
# on the solo basis, and above MIN_UNCAPPED_DUTY while it is off; the
# sampler's throttled time within one tick of the timeline's.  Memory:
# 24000 + 40000 MiB of grants and two 640 MiB context charges.
CORES_SM_LIMIT = 50
CORES_SERVE_MIB = 24000
CORES_TRAIN_MIB = 40000
MONITOR_INTERVAL_S = 0.5
# The control-plane child's register stream beats every second; each beat
# carries the usage rows of vgpu-monitor's NodeTPUInfo (leg (b)).
REGISTER_BEAT_S = 1.0
TIMELINE_S = 0.1
SWITCH_ON_TICKS = 2
SWITCH_OFF_TICKS = 5
# A launch sets the region's recent_kernel to 3 and each monitor tick ages
# it by one (csrc/vgpu/rate_limiter.cc): the sampler credits a pod as
# active for up to 3 ticks past its last launch.
CENSUS_TICKS = 3
CORES_SOLO_S = 3.0     # T alone before S's first launch (F1's window)
CORES_BURST_S = 10.0   # waves back to back
CORES_IDLE_S = 8.0     # S idle between its two bursts
CORES_TAIL_S = 4.0     # T alone after S's last launch
CORES_TIERED_S = 16.0  # S's waves in the tiered leg (20 before PR 19)
CORES_ALONE_S = 4.0    # S's waves alone, in each of 2 pairs without and
#                        with the interposer, in turn (8 before PR 19:
#                        the cut that pays for the gang leg)
ALONE = tuple(f"uidA{i}_serve" for i in range(4))  # odd: preloaded
# The device-plugin phase (phase_device_plugin): the port's node agent in a
# child that never imports torch (--enforce-child node_agent) lists the
# card through NVML, polls its health, registers it with the port's
# scheduler extender, and answers Allocate for two pods that the
# extender's webhook, Filter and Bind placed, S (CORES_SERVE_MIB, priority
# 0) and T (CORES_TRAIN_MIB, priority 1), each CORES_SM_LIMIT of the card
# by their resources; it polls NODE_AGENT_POLLS more times, 0.5 s
# apart, while nvidia-smi is sampled every NODE_AGENT_SMI_S: the card's
# used memory may not rise past TOL_CONTEXT_MIB (no context).  Then S and T
# run as the pods a kubelet would start from those answers: one flat leg
# of phase_coresidency, S's waves for one burst of CORES_BURST_S.  The
# node's registration must reach the scheduler within REGISTER_WAIT_S.
PLUGIN_NODE = "h100-node"
PLUGIN_PODS = (("serve", "uidDS", CORES_SERVE_MIB, 0),
               ("train", "uidDT", CORES_TRAIN_MIB, 1))
NODE_AGENT_POLLS = 4
NODE_AGENT_SMI_S = 0.1
REGISTER_WAIT_S = 30.0
# The fabric, in the same child.  The real node: NVML's NVLink P2P matrix
# (one card: the card with itself, nothing between cards) is recorded and
# the node must register mesh (1,) with its card at (0,); kubelet, over the
# plugin's socket, reads the options and asks for PREFERRED_SIZES of all
# the card's virtual IDs and for 2 with one must-include: each answer must
# be SliceAllocator.preferred's on the same inventory under the plugin's
# policy (PLUGIN_POLICY), on the one card, and the node carries no
# vtpu.dev/ici-unsatisfiable-sizes.  Then a mock HGX node beside it, once
# S and T are bound: a second node agent (--enforce-child mock_agent, no
# torch) on the mock NVML with HGX_FIXTURE (eight 81,079 MiB cards, every
# pair NVLink OK) streams to the same scheduler as HGX_NODE, which must
# register an (8,) ring.  HGX_PODS then go through the port's webhook,
# Filter (offered both nodes) and Bind: whole cards of HGX_MIB each, so
# each card they take is busy for the next: a guaranteed 4-card pod on a
# ring arc, a vtpu.dev/mesh "2" pod on a neighbouring pair, one card, and
# (the mesh pod deleted) a guaranteed 3-card pod that no free arc holds
# (Filter's no-ici-slice); a malformed mesh is refused by the webhook with
# the JAX package's message (BAD_MESH_MESSAGE); then the PCIe node
# (PCIE_NODE, a third agent) and PCIE_PODS.  The pods never run: the
# node lock is released after each Bind, as the node's Allocate would,
# and deleting them must free their grants.
PLUGIN_POLICY = "guaranteed"
PREFERRED_SIZES = (1, 2)
HGX_NODE = "hgx-node"
HGX_FIXTURE = {"generation": "h100", "mesh": [8], "hbm_mib": 81079,
               "fabric": "nvswitch"}
HGX_MIB = 1000
GUARANTEED = {"vtpu.dev/topology-policy": "guaranteed"}
HGX_PODS = (("ring4", "uidX4", 4, GUARANTEED),
            ("mesh2", "uidXM", 2, {"vtpu.dev/mesh": "2"}),
            ("pin", "uidXP", 1, {}),
            ("arc3", "uidX3", 3, GUARANTEED))
# The PCIe node beside it (PCIE_FIXTURE: four cards, no pair NVLink OK),
# so no fabric: its cards register without coordinates, it adds no mesh
# to the fleet's fabrics, and PCIE_PODS, offered it alone, get Filter's
# topology-unverifiable (a guaranteed 2-card pod and a mesh "2" pod) or
# the plain choice of two cards (a 2-card pod of the default policy).
# name, uid, cards, annotations, Filter's reason ("": placed).
PCIE_NODE = "pcie-node"
PCIE_FIXTURE = {"generation": "h100", "mesh": [4], "hbm_mib": 81079,
                "fabric": "pcie"}
PCIE_PODS = (("pguar2", "uidXG", 2, GUARANTEED, "topology-unverifiable"),
             ("pmesh2", "uidXN", 2, {"vtpu.dev/mesh": "2"},
              "topology-unverifiable"),
             ("pplain2", "uidXQ", 2, {}, ""))
BAD_MESH = "2x"
BAD_MESH_MESSAGE = "vtpu.dev/mesh: mesh '2x' must look like '2x4'"
# Card partitions (MIG), in the same child.  The card runs with MIG off,
# and nothing here changes its mode: NVML's MIG answer for it goes beside
# nvidia-smi's (MIG_MODE_NAMES), and under --partition-strategy mixed an
# agent's inventory must make no partition plugin and give kubelet and the
# scheduler what it gives under none.  Then a mock MIG node: the real entry
# point (vgpu-device-plugin --partition-strategy mixed, --enforce-child
# mock_agent with MOCK_AGENT_ARGS, no torch) on the mock NVML with
# MIG_FIXTURE (four 81,079 MiB cards; cards 0 and 1 with two 3g.40gb MIG
# devices each, card 2 with seven 1g.10gb, card 3 MIG off), its sockets in
# a directory of its own, where the child acts as kubelet: the Register
# calls (MIG_REGISTERED), each MIG plugin's ListAndWatch, preferred
# allocations, Allocate of one 3g.40gb device (its UUID, its MiB, no SM
# limit, a part-<sha1> region dir) and of an unknown ID
# (INVALID_ARGUMENT).  The scheduler must hold card 3 alone, and a
# whole-card pod of MIG_WHOLE_CARDS cards offered that node alone gets no
# node.  Two more agents under single exit non-zero at start, each with
# its MIG_REFUSALS message: a --partition-chips subset, and the two
# flavors.  These pods never run.
MIG_MODE_NAMES = {0: "Disabled", 1: "Enabled"}
# The chart leg, in the same child: charts/vgpu rendered with its default
# values as `helm template CHART_RELEASE[0] charts/vgpu -n
# CHART_RELEASE[1]` renders it (tests/gotmpl.py, with PyYAML), and the
# extender, the device plugin and the monitor started from the rendered
# containers' command and env, each mapped onto this host by CHART_MAP's
# rules (chart_mapping).  The agent must register the card with the
# chart-started extender within CHART_REGISTER_S of its start; each
# daemon must end within CHART_STOP_S of its SIGTERM.
CHART = ROOT / "charts" / "vgpu"
CHART_RELEASE = ("vgpu", "kube-system")
CHART_NODE = "chart-node"
CHART_REGISTER_S = 10.0
CHART_STOP_S = 5.0
CHART_POD = ("chartpod", "uidCP", 1000, 1)
# Where each rendered value goes on this host.
CHART_MAP = {
    "python": "sys.executable",
    "service DNS names and ports, binds": "free 127.0.0.1 ports",
    "hostPath": "a directory under the leg's tmp",
    "/config/config.json": "the rendered node ConfigMap's config.json",
    "NODE_NAME": CHART_NODE,
    "extender, device plugin": "--fake-kube appended (no apiserver)",
    "TLS flags": "a pair from `openssl req -x509`, or dropped without openssl",
}
# PromQL words that are not metric names, and the series Prometheus
# writes itself for each scrape (dashboard_metrics).
PROMQL_KEYWORDS = {"and", "or", "unless", "offset", "bool", "by", "without",
                   "on", "ignoring", "group_left", "group_right", "inf",
                   "nan"}
SCRAPE_SERIES = {"up"}
MIG_NODE = "mig-node"
MIG_3G_MIB = 40448
MIG_1G_MIB = 9984
MIG_FIXTURE = {"generation": "h100", "mesh": [4], "hbm_mib": 81079, "chips": [
    {"coords": [i], "uuid": f"GPU-mig-node-{i}", "mig": [
        {"slices": s, "mib": mib, "uuid": f"MIG-mig-node-{i}-{k}"}
        for k in range(n)]}
    for i, (n, s, mib) in enumerate(((2, 3, MIG_3G_MIB), (2, 3, MIG_3G_MIB),
                                     (7, 1, MIG_1G_MIB)))] + [
    {"coords": [3], "uuid": "GPU-mig-node-3"}]}
MIG_REGISTERED = [("nvidia.com/gpu", "vgpu.sock"),
                  ("nvidia.com/mig-1g.10gb", "vgpu-1g.10gb.sock"),
                  ("nvidia.com/mig-3g.40gb", "vgpu-3g.40gb.sock")]
MIG_WHOLE_CARDS = 2
MIG_REFUSALS = {"subset": "would strand chips",
                "flavors": "MIG devices of 2 flavors"}
# The runtime wrapper on the card, last in the phase: a bundle whose
# process is --enforce-child oci_pod (torch and nothing of the port), with
# an image PYTHONPATH of its own that holds OCI_PROBE, injected by
# vgpu-oci-runtime create under an oci.json that grants the card
# OCI_GRANT_MIB, oversubscribed (so the shim dir goes on PYTHONPATH before
# the image's); a stand-in runtime (the machine has no root for runc)
# starts it with the bundle's env and its bind mounts read as kubelet_env
# reads an answer's.  Then delete with a broken oci.json.
OCI_GRANT_MIB = 4000
OCI_PROBE = "oci_image_probe"
# The preemption phase (phase_preempt): the train step at llama_7b widths
# through the interposer under T's 40000 MiB grant, PREEMPT_STEPS steps of
# one batch (5, not 6: the script's time goes to the simulator's legs);
# the high-priority pod arrives once the victim has finished step 3, and
# the parent mirrors the annotations the scheduler wrote into the victim's
# file, as kubelet would; the card's memory must fall back to the parent's
# own within 5 s of the victim's exit (64 MiB: TOL_CONTEXT_MIB's slack).
# The step is T's at PREEMPT_LAYERS layers (4, not 8: the script ran past
# its 1200 s on a slow host, and the phase's time is mostly its
# checkpoints' reads and writes, 12 B a parameter); H's host swap runs the
# same step, so its losses are R's first ones.  R's checkpoint goes to the
# disk, V's and V''s to SHM, a tmpfs in host memory: the card's machine
# ends a command once it has written 45 GiB to its disk, deleted files
# included.  A control-plane call gets PLANE_CALL_S.
# V (the victim, priority 1) and V' (V rescheduled, a new pod on V's
# checkpoints) ask for T's 40000 MiB; H (priority 0, oversubscribed, host
# swap's pod) for 48000 MiB, which does not fit beside V on the 81,079
# MiB the node agent advertises.  name, uid, MiB, priority, annotations.
PREEMPT_LAYERS = 4
SHM = Path("/dev/shm")
PREEMPT_MIB = CORES_TRAIN_MIB
PREEMPT_H_MIB = 48000
PREEMPT_PODS = {
    "V": ("trainer", "uidPV", PREEMPT_MIB, 1, {}),
    "H": ("serve-hp", "uidPH", PREEMPT_H_MIB, 0,
          {"vtpu.dev/oversubscribe": "true"}),
    "V2": ("trainer-2", "uidPV2", PREEMPT_MIB, 1, {})}
PREEMPT_STEPS = 5
PREEMPT_AFTER = 3
# phase_preempt's quota leg (quota_leg): the control plane's capacity
# queues, two in one cohort: team-a with no nominal (all it holds is
# borrowed), team-b entitled to one card (team-g, the gang leg's, is in a
# cohort of its own).  R, V, H and V' stay in the
# ungoverned "default".  B (team-a) and E (team-b) ask for QUOTA_MIB
# each: both fit beside V''s grant, not together.  The admission loop is
# ticked through the control plane's stdin; its reclaim grace is
# QUOTA_GRACE_S, and its release throttle counts QUOTA_HEADROOM grants a
# card (the split count: every grant of the phase shares the one card).
# B's kernel loop ends, failing, after QUOTA_POD_S without a request.
QUOTA_QUEUES = [{"name": "team-a", "namespaces": ["team-a"], "cohort": "lab",
                 "quota": {"chips": 0}, "borrow_limit_chips": 1},
                {"name": "team-b", "namespaces": ["team-b"], "cohort": "lab",
                 "quota": {"chips": 1}},
                {"name": "team-g", "namespaces": ["team-g"],
                 "cohort": "gang", "quota": {"chips": 2}}]
QUOTA_PODS = {"B": ("borrower", "uidQB", "team-a"),
              "E": ("entitled", "uidQE", "team-b")}
QUOTA_MIB = 24000
QUOTA_GRACE_S = 2.0
QUOTA_HEADROOM = 10.0
QUOTA_POD_S = 120.0
# phase_preempt's gang leg (GangLeg, inside quota_leg): the two members of
# pod group GANG_GROUP in team-g (a queue of its own cohort, nominal 2),
# each asking for GANG_MIB of the card: one fits beside E's and V''s
# grants (64,000 of 81,079 MiB), two do not, and both fit once E is gone.
# GANG_MIB is checked against the remainder /fleetz shows, and taken as
# two thirds of it where it does not fit that moment.  Each member joins a
# gloo group from its Allocate env (its rendezvous and collectives bounded
# by GANG_TIMEOUT_S), runs the flash forward kernel in bf16 at GANG_SHAPE,
# causal, seeded by its rank, and all-reduces its error and checksum.
GANG_NS = "team-g"
GANG_GROUP = "ring"
GANG_PODS = (("ring-0", "uidG0"), ("ring-1", "uidG1"))
GANG_MIB = 12000
GANG_SHAPE = (1, 2048, 32, 128)
GANG_TIMEOUT_S = 60.0
# The capacity simulator's legs of phase_preempt (FleetView): the scale
# leg replays SIM_FLEET (968 pods) on SIM_SCALE, 128 nodes of eight H100s
# at the card's advertised MiB, starting with the phase so that it runs
# beside the pods; the live leg replays one pod of the card's remaining
# MiB, and one of a MiB more, against the extender's /fleetz.
SIM_FLEET = ROOT / "examples" / "vgpu-simulate-fleet.json"
SIM_SCALE = ("--nodes", "128", "--chips", "8", "--hbm", "81079", "--mesh",
             "8", "--policy", "binpack")
SIM_TIMEOUT_S = 300.0
PLANE_CALL_S = 120.0
RETURN_S = 5.0
TOL_RETURN_MIB = 64
# The quantized serving phase (phase_quant_serve): the 32-layer model
# written as a checkpoint and served by the pod's own entry point under a
# grant its bf16 weights cannot fit (8000 MiB, which refuses their load
# in phase_enforce) as int8, and as int4 under 5000 MiB; fidelity on a
# (1, 512) prompt: the int8 logits' cosine to the bf16 ones above the JAX
# package's own bound (tests/test_quant.py); QuantLinear4 against the JAX
# package's QuantDense4 written in plain torch over weights unpacked apart
# from quant.py, on 2 layers: relative RMS within 4x the first reading on
# an H100 80GB HBM3 at 700 W (0.0169; a control that swaps each byte's
# nibbles read 1.43 and must stay past the limit).
QUANT_GRANT_MIB = {"int8": 8000, "int4": 5000}
QUANT_PROMPT = 512
MIN_INT8_COSINE = 0.999
TOL_INT4_VS_GROUP_SUMS = 4 * 0.0169
PROFILE_S = 1.0
# The workloads phase (phase_workloads): the reference's ten benchmark
# cases (models/workloads.py, bench.py's CASES), at full shape with seeded
# weights, on bare metal (one child, no interposer, the ten in turn) and
# each as a pod through the interposer under its memory grant and no
# compute limit, as bench.py's pods run.  Both legs: cuDNN's heuristics
# (benchmark off: no autotuning, whose workspaces a grant may refuse) and
# no TF32.  The bf16 output (step-0 loss in training) against the f32
# path of the same weights on the card: relative RMS of the logits, the
# loss's relative error; each case's limit 4x its first reading on an
# H100 80GB HBM3 at 700 W (in brackets), the same in both legs.
WORKLOAD_SEED = SEED + 11
TOL_WORKLOAD = {
    "resnet_v2_50_inference_bf16_b50_346": 2.02e-2,   # (5.04e-3)
    "resnet_v2_152_inference_bf16_b10_256": 4.48e-2,  # (1.12e-2)
    "resnet_v2_50_train_bf16_b20_346": 3.33e-4,       # (8.33e-5)
    "vgg16_inference_bf16_b20_224": 2.96e-2,          # (7.40e-3)
    "deeplab_inference_bf16_b2_512": 0.131,           # (3.27e-2)
    "lstm_inference_bf16_b100_1024x300": 1.35e-2,     # (3.36e-3)
    "resnet_v2_152_train_bf16_b10_256": 8.16e-4,      # (2.04e-4)
    "vgg16_train_bf16_b2_224": 2.82e-5,               # (7.04e-6)
    "deeplab_train_bf16_b1_384": 4.51e-4,             # (1.13e-4)
    "lstm_train_bf16_b10_1024x300": 3.53e-4,          # (8.84e-5)
}
# Timed windows a case and leg, of which the median is reported: the
# host-bound cases' images/s moved by up to a quarter window to window on
# one card (the host's cores are shared; more between the legs' runs).
# Two, not three: the script's time goes to the node's and the fleet's
# observability legs instead (of two, the slower window is reported).
WORKLOAD_WINDOWS = 2
WORKLOAD_PROFILED = ("resnet_v2_50_inference_bf16_b50_346",
                     "resnet_v2_50_train_bf16_b20_346")
# Device time of a workload's profile by kernel family (first match).
WORKLOAD_GROUPS = {"conv": ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                            "implicit"),
                   "norm": ("Welford", "addcmul"),
                   "matmul": ("gemm", "nvjet", "cutlass", "sm90_xmma"),
                   "elementwise": ("elementwise", "reduce_kernel", "copy",
                                   "Copy", "pool", "CatArray")}
SMI_EVERY_S = 0.5
# A reading of the card's used memory (smi_card_mib) is the least of
# NVML's readings every CARD_EVERY_S over CARD_WINDOW_S.  The card on
# the machine this script runs on rises 435-526 MiB for under 0.1 s
# about once a minute with no process of this machine on it, none of
# them holding a context and none in NVML's process lists
# (tools/card_transients.py): a memory reading that lands in it counts
# memory that belongs to no pod.  The window is twice the longest such
# rise seen, so it never holds one alone; what a pod holds for a window
# shows whole.  A window whose highest reading stands past both ends by
# CARD_TRANSIENT_MIB is kept in CARD_TRANSIENTS (this process's) and
# printed at the end.
CARD_WINDOW_S = 0.2
CARD_EVERY_S = 0.005
CARD_TRANSIENT_MIB = 256
CARD_TRANSIENTS: list = []
# Run with -I -S by a process without the preloaded interposer (which
# virtualises NVML): prints the window's least, highest, first and last
# readings of NVML's v2 ``used`` (nvidia-smi's ``memory.used``) in MiB.
CARD_WINDOW = r"""
import ctypes, sys, time
class Mem(ctypes.Structure):
    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]
nvml = ctypes.CDLL("libnvidia-ml.so.1")
card = ctypes.c_void_p()
if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
        0, ctypes.byref(card)):
    sys.exit("NVML found no card")
mem = Mem(version=ctypes.sizeof(Mem) | 2 << 24)
got = []
t0 = time.monotonic()
while len(got) < 2 or time.monotonic() - t0 < float(sys.argv[1]):
    rc = nvml.nvmlDeviceGetMemoryInfo_v2(card, ctypes.byref(mem))
    if rc:
        sys.exit(f"nvmlDeviceGetMemoryInfo_v2 returned {rc}")
    got.append(mem.used >> 20)
    time.sleep(float(sys.argv[2]))
print(min(got), max(got), got[0], got[-1])
"""
# vgpu_interposer_stats' fields (csrc/vgpu/cuda_interposer.cc).
INTERPOSER_STATS = ("launches", "gated", "charged_us", "samples",
                    "sampled_us", "context_bytes", "alloc_bytes",
                    "refusals", "capture_skips", "fixed_bytes")
# The grant env of every child, cleared of whatever the caller's env holds.
GRANT_ENV = ("CUDA_DEVICE_MEMORY_", "CUDA_DEVICE_SM_LIMIT",
             "CUDA_TASK_PRIORITY", "CUDA_OVERSUBSCRIBE", "NVIDIA_VISIBLE_",
             "GPU_CORE_UTILIZATION_POLICY", "ACTIVE_OOM_KILLER", "VTPU_",
             "LD_PRELOAD", "POD_", "PYTHONPATH")


class Fail(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Fail(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def ptxas_kernels(build_log: str) -> list:
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: its name and
    head_dim (the first template argument), registers a thread and spill
    bytes (stores + loads)."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(flash_[a-z_]+_kernel)(?:ILi(\d+)E)?",
                             m.group(1))
            cur = dict(kernel=name.group(1) if name else m.group(1),
                       head_dim=int(name.group(2)) if name and name.group(2)
                       else None, registers=None, spill_bytes=None)
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def nvidia_smi(query: str) -> str:
    """The first card's ``--query-gpu`` fields, as nvidia-smi prints them."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def smi_env() -> dict:
    """This env without a preloaded library: nvidia-smi must read the
    card, not a grant (the interposer virtualises NVML)."""
    return {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}


def smi_card_mib() -> int:
    """The card's used memory (nvidia-smi's ``memory.used``, NVML's v2
    ``used``), in MiB: the least reading over CARD_WINDOW_S (see there)."""
    res = subprocess.run([sys.executable, "-I", "-S", "-c", CARD_WINDOW,
                          str(CARD_WINDOW_S), str(CARD_EVERY_S)],
                         env=smi_env(), capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"NVML failed: {res.stderr.strip()}")
    least, most, first, last = map(int, res.stdout.split())
    if most - max(first, last) > CARD_TRANSIENT_MIB:
        CARD_TRANSIENTS.append((time.monotonic(), least, most))
    return least


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the summed time of its kernels
    under torch.profiler over ``iters`` calls, without the host's gaps."""
    fn()
    busy = device_profile(torch, lambda: [fn() for _ in range(iters)])
    return busy["device_busy_ms"] / iters


_TRACER_STARTED: list = []


def device_profile(torch, fn, top: int = 6, groups=None) -> dict:
    """One traced call of ``fn`` (torch.profiler, CPU + CUDA activity):
    its wall time, the summed time of its device kernels and their share
    of the wall (the device's busy share), their device time by family
    (``groups``, default KERNEL_GROUPS), and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if not _TRACER_STARTED:
        # The process's first trace starts CUPTI; one read 30 of a
        # forward's 32 flash launches.  Started on a few small kernels,
        # whose trace is not read.
        x = torch.zeros(1, device="cuda")
        with profile(activities=activities):
            for _ in range(8):
                x.add_(1)
            torch.cuda.synchronize()
        _TRACER_STARTED.append(True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n, tot = kernels.get(evt.name, (0, 0.0))
            kernels[evt.name] = (n + 1, tot + evt.time_range.elapsed_us())
    busy_us = sum(tot for _, tot in kernels.values())
    check(busy_us > 0, "the profiler saw no device kernel")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    groups = groups or KERNEL_GROUPS
    by_group = dict.fromkeys(list(groups) + ["other"], 0.0)
    for name, (_, tot) in kernels.items():
        group = next((g for g, keys in groups.items()
                      if any(key in name for key in keys)), "other")
        by_group[group] += tot / 1e3
    port_calls = {key: sum(n for name, (n, _) in kernels.items()
                           if key in name)
                  for key in KERNEL_GROUPS["port_kernels"]}
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(n for n, _ in kernels.values()),
        "ms_by_group": by_group,
        "port_kernel_calls": port_calls,
        "top_kernels": [{"name": name[:90], "calls": n, "ms": tot / 1e3,
                         "share_of_busy": tot / busy_us}
                        for name, (n, tot) in ranked],
    }


def attention_pairs(T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return T * T
    if window <= 0:
        return T * (T + 1) // 2
    return sum(min(p + 1, window) for p in range(T))


# Per kernel: flops per (query, key) pair and head-dim element; (B, T, H,
# d) tensors moved (read once or written once); f32 (B, H, T) rows read.
# Forward: QK^T, PV; q, k, v in, O out.  dQ: QK^T, dO V^T, dS K; q, k, v,
# dO in, dQ out; lse, Δ in.  dK/dV: the same two plus P^T dO, dS^T Q;
# dK, dV out.
BOUND_COUNTS = {"fwd": (4, 4, 0), "dq": (6, 5, 2), "dkv": (8, 6, 2)}


def flash_bound(B, T, H, d, dtype: str, causal: bool, window: int,
                kind: str = "fwd"):
    """Least time on the card for one ``kind`` kernel call: the larger of
    operations over the peak rate of the input type and bytes (each input
    read once, each output written once) over the memory rate."""
    per_pair, tensors, rows = BOUND_COUNTS[kind]
    flops = per_pair * B * H * d * attention_pairs(T, causal, window)
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * T * H * d * itemsize + rows * B * H * T * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_cases():
    cases = []
    for dtype in ("float32", "bfloat16"):
        for d in (64, 128):
            for T in (128, 200, 2048):
                cases.append(dict(dtype=dtype, d=d, T=T, window=0,
                                  causal=True, lse=True))
        for window, lse in ((1, True), (16, False), (48, True),
                            (128, False)):
            cases.append(dict(dtype=dtype, d=128, T=2048, window=window,
                              causal=True, lse=lse))
        cases.append(dict(dtype=dtype, d=64, T=200, window=48, causal=True,
                          lse=False))
        cases.append(dict(dtype=dtype, d=128, T=200, window=0, causal=False,
                          lse=True))
        for d in (16, 32):
            cases.append(dict(dtype=dtype, d=d, T=200, window=0,
                              causal=True, lse=True))
    # Views that are not contiguous, which the kernels read through their
    # strides (appended last, so the cases above draw the same inputs).
    for dtype in ("float32", "bfloat16"):
        cases += [dict(dtype=dtype, d=128, T=200, window=0, causal=True,
                       lse=True, layout="fused"),
                  dict(dtype=dtype, d=64, T=200, window=48, causal=True,
                       lse=False, layout="bhtd"),
                  dict(dtype=dtype, d=128, T=2048, window=128, causal=True,
                       lse=True, layout="odd_b1")]
    return cases


def operands(torch, c, B, H, n, gen):
    """``n`` (B, T, H, d) inputs of case ``c`` in its layout: contiguous;
    ``fused``, slices of one (B, T, n, H, d) buffer (as a fused QKV
    projection gives them); ``bhtd``, a (B, H, T, d) tensor transposed;
    ``odd_b1``, B = 1 with a batch stride of 1, which is never stepped."""
    dt = getattr(torch, c["dtype"])
    layout = c.get("layout", "contiguous")

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dt)

    T, d = c["T"], c["d"]
    if layout == "fused":
        return randn(B, T, n, H, d).unbind(2)
    if layout == "bhtd":
        return tuple(randn(B, H, T, d).transpose(1, 2) for _ in range(n))
    xs = tuple(randn(B, T, H, d) for _ in range(n))
    if layout == "odd_b1":
        check(B == 1, "odd_b1 needs B = 1")
        return tuple(x.as_strided(x.shape, (1,) + x.stride()[1:])
                     for x in xs)
    return xs


def bad_bf16_operands(torch):
    """A contiguous bf16 (1, 128, 4, 64) operand, and two of the same shape
    that the tensor-core kernels cannot copy 16 bytes at a time: data 2
    bytes off 16-byte alignment, and an odd token stride."""
    B, T, H, d = 1, 128, 4, 64
    q = torch.zeros(B, T, H, d, device="cuda", dtype=torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    wide = torch.zeros(B, T, H * d + 1, device="cuda", dtype=torch.bfloat16)
    return q, {"misaligned": flat[1:].view(B, T, H, d),
               "odd_token_stride": wide[..., :H * d].unflatten(-1, (H, d))}


def refusals(torch, counters, calls) -> dict:
    """Which of ``calls`` raised ValueError, and the kernel launches the
    ``counters`` counted meanwhile."""
    before = sum(f.launches for f in counters)
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except ValueError:
            refused[name] = True
    torch.cuda.synchronize()
    return dict(refused=refused,
                launches=sum(f.launches for f in counters) - before)


def check_refusals(torch, fa, record):
    """A bf16 operand the tensor-core kernel cannot copy 16 bytes at a time
    raises before anything is launched: there is no fallback to the scalar
    kernel."""
    q, bad = bad_bf16_operands(torch)
    got = record["bf16_refusals"] = refusals(
        torch, (fa.flash_attention,),
        {name: lambda x=x: fa.flash_attention(x, q, q)
         for name, x in bad.items()})
    log("bf16 refusals", json.dumps(got))
    check(all(got["refused"].values()) and got["launches"] == 0,
          f"a bf16 operand cp.async cannot take was not refused: {got}")


def check_backward_refusals(torch, fa, record):
    """The backward twin of check_refusals: each bad bf16 operand, as dO
    of either backward kernel, raises with no backward launch."""
    q, bad = bad_bf16_operands(torch)
    B, T, H, d = q.shape
    rows = torch.zeros(B, H, T, device="cuda")
    calls = {}
    for name, x in bad.items():
        for f in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            calls[f"{f.__name__}_{name}"] = (
                lambda f=f, x=x: f(q, q, q, x, rows, rows, d ** -0.5, True))
    got = record["bf16_backward_refusals"] = refusals(
        torch, (fa.flash_bwd_dq, fa.flash_bwd_dkv), calls)
    log("bf16 backward refusals", json.dumps(got))
    check(all(got["refused"].values()) and got["launches"] == 0,
          f"a bf16 backward operand cp.async cannot take was not refused: "
          f"{got}")


def phase_kernel(torch, fa, record):
    """Every case: the kernel against the plain version on the card (f32
    through the scalar kernel, bf16 through the tensor-core one); then the
    bf16 layouts the wrapper refuses."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for c in kernel_cases():
        B, H = (1, 32) if c["T"] == 2048 else (2, 4)
        dt = getattr(torch, c["dtype"])
        q, k, v = operands(torch, c, B, H, 3, gen)
        got = fa.flash_attention(q, k, v, causal=c["causal"],
                                 window=c["window"], return_lse=c["lse"])
        want = fa._reference(q, k, v, c["d"] ** -0.5, c["causal"],
                             c["window"], return_lse=c["lse"])
        torch.cuda.synchronize()
        if not c["lse"]:
            got, want = (got, None), (want, None)
        check(got[0].dtype == dt and got[0].shape == q.shape,
              f"kernel output dtype/shape {c}")
        check(bool(torch.isfinite(got[0].float()).all()),
              f"kernel output not finite {c}")
        if c["dtype"] == "float32":
            err = (got[0] - want[0]).abs().max().item()
            row = dict(c, B=B, H=H, max_abs_err=err, tol=TOL_O)
            ok = err <= TOL_O
        else:
            row = dict(c, B=B, H=H, **grad_errors(torch, got[0], want[0],
                                                  False))
            row.update(tol_rel_max=2 ** -7 + 2 ** -8 * v.float().abs().max()
                       .item() / row["max_abs_want"],
                       tol_rel_rms=TOL_O_BF16_RMS,
                       tol_tile_rel_rms=TOL_O_BF16_TILE)
            ok = (row["rel_max_err"] <= row["tol_rel_max"]
                  and row["rel_rms_err"] <= TOL_O_BF16_RMS
                  and row["tile_rel_rms_err"] <= TOL_O_BF16_TILE)
        if c["lse"]:
            row["lse_err"] = (got[1] - want[1]).abs().max().item()
            row["lse_tol"] = TOL_LSE[c["dtype"]]
            ok = ok and row["lse_err"] <= row["lse_tol"]
        rows.append(row)
        log("kernel case", json.dumps(row))
        check(ok, f"kernel disagrees with its plain version: {row}")
    record["kernel_cases"] = rows
    check_refusals(torch, fa, record)

    # Times at the main path's shape: one llama_7b layer's attention.
    B, T, H, d = 1, 2048, 32, 128
    q, k, v = (torch.randn(B, T, H, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    main = [r for r in rows if r["dtype"] == "bfloat16" and r["T"] == T
            and r["d"] == d and r["window"] == 0][0]
    t_kernel = cuda_ms(torch, lambda: fa.flash_attention(q, k, v))
    t_plain = cuda_ms(torch, lambda: fa._reference(q, k, v, d ** -0.5, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    # The scalar kernel, which every f32 call takes, at the same shape.
    q32, k32, v32 = (x.float() for x in (q, k, v))
    t_f32 = cuda_ms(torch, lambda: fa.flash_attention(q32, k32, v32))
    bound_ms, bound_by = flash_bound(B, T, H, d, "bfloat16", True, 0)
    record["flash_fwd_timing"] = dict(
        shape=[B, T, H, d], dtype="bfloat16", causal=True, ms=t_kernel,
        plain_ms=t_plain, library_ms=t_lib, f32_ms=t_f32,
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / t_kernel,
        tflops=4 * B * H * d * attention_pairs(T, True, 0) / t_kernel / 1e9,
        max_abs_err=main["max_abs_err"],
        errors={key: main[key] for key in
                ("rel_max_err", "rel_rms_err", "tile_rel_rms_err",
                 "max_abs_want")})
    log("flash_fwd timing", json.dumps(record["flash_fwd_timing"]))


def backward_inputs(fa, q, k, v, do, causal: bool, window: int):
    """The backward's arguments as the train step makes them: lse from the
    forward kernel, Δ from its O."""
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return (q, k, v, do, lse, fa._delta(out, do), q.shape[-1] ** -0.5,
            causal, window)


def backward_kernels(fa, args):
    return (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)


def grad_errors(torch, got, want, zero: bool) -> dict:
    """How far one (B, T, H, d) kernel output (a bf16 O, dQ, dK or dV)
    lies from the plain one: the largest error and value, and unless the
    output is ``zero`` by the mathematics, the errors on its own scale
    (see TOL_GRAD)."""
    diff = got.float() - want.float()
    row = dict(max_abs_err=diff.abs().max().item(),
               max_abs_want=want.float().abs().max().item())
    if zero:
        return row
    B, T, H, d = diff.shape
    tiles = -(-T // GRAD_TILE)

    def tile_sq(x):  # squared norm of each (batch, tile, head) block
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, tiles * GRAD_TILE - T))
        return x.square().reshape(B, tiles, GRAD_TILE, H, d).sum((2, 4))

    row.update(rel_max_err=row["max_abs_err"] / row["max_abs_want"],
               rel_rms_err=(diff.norm() / want.float().norm()).item(),
               tile_rel_rms_err=(tile_sq(diff) / tile_sq(want.float()))
               .sqrt().max().item())
    return row


def grad_max_limits(torch, fa, args, want) -> dict:
    """The bf16 tensor-core backward's limit on max|got - want| / max|want|
    for each of dQ, dK, dV: 2**-7 + 2**-8 max(B) / max|want|, derived from
    its rounding.  Rounding P (before Pᵀ dO) or dS (before dS K and dSᵀ Q)
    to bf16 moves each entry by at most 2**-8 of itself, so an output
    element by at most 2**-8 of the same sum over absolute values, B: for
    dV, Pᵀ|dO|; for dK, scale·|dS|ᵀ|Q|; for dQ, scale·|dS||K|, each
    computed in f32 by the plain code from the same inputs.  Both sides
    round the output to bf16, each by at most 2**-8 of max|want|."""
    q, k, _, do, _, _, scale, _, _ = args
    _, p, ds = fa._recompute(*args)
    ads = ds.abs()
    bound = dict(
        dq=torch.einsum("bhts,bshd->bthd", ads, k.float().abs()) * scale,
        dk=torch.einsum("bhts,bthd->bshd", ads, q.float().abs()) * scale,
        dv=torch.einsum("bhts,bthd->bshd", p, do.float().abs()))
    return {name: 2 ** -7 + 2 ** -8 * bound[name].max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for name, w in zip(("dq", "dk", "dv"), want)}


def judge_backward(torch, fa, args, got, want):
    """Each of (dQ, dK, dV) ``got`` against the plain ``want`` on the
    backward's inputs ``args``: its errors (grad_errors) beside the limits
    of its dtype (see TOL_GRAD), and whether all three keep them."""
    q, *_, causal, window = args
    dtype = str(q.dtype).removeprefix("torch.")
    limits = (grad_max_limits(torch, fa, args, want)
              if dtype == "bfloat16" else None)
    ok, rows = True, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        zero = causal and window == 1 and name != "dv"
        e = rows[name] = grad_errors(torch, g, w, zero)
        if zero:
            e["tol_abs"] = TOL_GRAD_ZERO
            ok = ok and max(e["max_abs_err"], e["max_abs_want"]) \
                <= TOL_GRAD_ZERO
            continue
        e.update(tol_rel_max=limits[name] if limits else TOL_GRAD,
                 tol_rel_rms=TOL_GRAD_RMS[dtype],
                 tol_tile_rel_rms=TOL_GRAD_TILE[dtype])
        ok = ok and e["rel_max_err"] <= e["tol_rel_max"] \
            and e["rel_rms_err"] <= e["tol_rel_rms"] \
            and e["tile_rel_rms_err"] <= e["tol_tile_rel_rms"]
    return ok, rows


def phase_backward_kernels(torch, fa, record):
    """Every forward case again for the backward kernels (f32 through the
    scalar kernels, bf16 through the tensor-core ones) against the plain
    backward on the card (judge_backward); the bf16 layouts they refuse;
    bitwise repeatability; times at the main path's shape, bf16 and the f32
    scalar kernels, beside the plain backward's and SDPA's backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for c in kernel_cases():
        c = {key: val for key, val in c.items() if key != "lse"}
        B, H = (1, 32) if c["T"] == 2048 else (2, 4)
        dt = getattr(torch, c["dtype"])
        q, k, v, do = operands(torch, c, B, H, 4, gen)
        args = backward_inputs(fa, q, k, v, do, c["causal"],
                               c["window"])
        got = backward_kernels(fa, args)
        want = (fa._dq_reference(*args),) + fa._dkv_reference(*args)
        torch.cuda.synchronize()
        for name, g in zip(("dq", "dk", "dv"), got):
            check(g.dtype == dt and g.shape == q.shape,
                  f"{name} dtype/shape {c}")
            check(bool(torch.isfinite(g.float()).all()),
                  f"{name} not finite {c}")
        ok, errors = judge_backward(torch, fa, args, got, want)
        row = dict(c, B=B, H=H, **errors)
        rows.append(row)
        log("backward case", json.dumps(row))
        check(ok, f"backward kernels disagree with the plain backward: {row}")
    record["backward_cases"] = rows
    check_backward_refusals(torch, fa, record)

    B, T, H, d = 1, 2048, 32, 128
    q, k, v, do = (torch.randn(B, T, H, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    args = backward_inputs(fa, q, k, v, do, True, 0)
    first = backward_kernels(fa, args)
    second = backward_kernels(fa, args)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"backward kernels bitwise repeatable: {bitwise}")
    check(bitwise, "two backward calls on the same inputs differ")

    main = [r for r in rows if r["dtype"] == "bfloat16" and r["T"] == T
            and r["d"] == d and r["window"] == 0][0]
    out = fa.flash_attention(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    # The scalar kernels, which every f32 call takes, at the same shape.
    args32 = backward_inputs(fa, *(x.float() for x in (q, k, v, do)), True,
                             0)
    timing = dict(
        shape=[B, T, H, d], dtype="bfloat16", causal=True,
        bitwise_repeatable=bitwise,
        dq_ms=cuda_ms(torch, lambda: fa.flash_bwd_dq(*args)),
        dkv_ms=cuda_ms(torch, lambda: fa.flash_bwd_dkv(*args)),
        dq_f32_ms=cuda_ms(torch, lambda: fa.flash_bwd_dq(*args32)),
        dkv_f32_ms=cuda_ms(torch, lambda: fa.flash_bwd_dkv(*args32)),
        delta_ms=cuda_ms(torch, lambda: fa._delta(out, do)),
        plain_dq_ms=cuda_ms(torch, lambda: fa._dq_reference(*args)),
        plain_dkv_ms=cuda_ms(torch, lambda: fa._dkv_reference(*args)),
        # SDPA's backward alone; one call gives dQ, dK and dV.  Its device
        # time comes from the profiler: events around autograd.grad also
        # time the host's launch gaps, which vary from run to run.
        library_ms=device_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True)),
        library_event_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True)),
        errors={name: main[name] for name in ("dq", "dk", "dv")})
    timing["kernels_and_delta_ms"] = (timing["dq_ms"] + timing["dkv_ms"]
                                      + timing["delta_ms"])
    for kind in ("dq", "dkv"):
        bound, by = flash_bound(B, T, H, d, "bfloat16", True, 0, kind)
        timing[f"{kind}_bound_ms"], timing[f"{kind}_bound_by"] = bound, by
    record["flash_bwd_timing"] = timing
    log("flash_bwd timing", json.dumps(timing))


def phase_forward_and_serve_f32(torch, port, record):
    """llama_7b widths, 2 layers, f32: flash logits against full; the
    engine token-exact against generate(); speculative decoding with an
    early-exit and a random draft, each token-identical to generate()."""
    llama, convert, generate, serve, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              dtype="float32", attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict(), assign=True)
    tokens = torch.randint(0, cfg.vocab, (1, 512), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        a = flash_model(tokens)
        b = full_model(tokens)
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    record["forward_f32_flash_vs_full"] = dict(
        layers=2, tokens=[1, 512], max_abs_err=err, tol=TOL_FLASH_VS_FULL)
    log("forward f32 flash vs full", json.dumps(
        record["forward_f32_flash_vs_full"]))
    check(bool(torch.isfinite(a).all()), "f32 flash logits not finite")
    check(err <= TOL_FLASH_VS_FULL, f"flash vs full logits: {err}")

    rng = torch.Generator().manual_seed(SEED)
    reqs = [(torch.randint(1, cfg.vocab, (n,), generator=rng).tolist(), 8)
            for n in (5, 17, 40, 64)]
    eng = serve.ServingEngine(flash_model, max_slots=2, max_len=128)
    ids = {eng.submit(p, n): (p, n) for p, n in reqs}
    done = eng.run()
    check(len(done) == len(reqs), "engine lost a request")
    for c in done:
        p, n = ids[c.request_id]
        want = generate.generate(flash_model, torch.tensor([p]), n)
        check(c.tokens == want[0, len(p):].tolist(),
              f"engine request {c.request_id} diverged from generate()")
    record["serve_f32_vs_generate"] = dict(
        requests=len(reqs), prompt_lens=[len(p) for p, _ in reqs],
        new_tokens=8, max_slots=2, token_exact=True)
    log("serve f32 vs generate", json.dumps(record["serve_f32_vs_generate"]))

    prompt = torch.randint(1, cfg.vocab, (1, SPEC_F32_PROMPT), generator=rng)
    want = generate.generate(flash_model, prompt, SPEC_F32_NEW)
    drafts = {"early_exit_1_layer": convert.early_exit_draft(flash_model, 1),
              "random_1_layer": convert.init_weights(
                  dataclasses.replace(cfg, n_layers=1),
                  torch.Generator(device="cuda").manual_seed(SEED + 9))}
    runs = {}
    for name, draft in drafts.items():
        got, stats = generate.speculative_generate(
            flash_model, draft, prompt, SPEC_F32_NEW, k=SPEC_K)
        check(torch.equal(got, want), f"f32 speculative decoding with the "
              f"{name} draft diverged from generate()")
        runs[name] = dict(stats, acceptance=stats["accepted"]
                          / max(1, stats["drafted"]), token_identical=True)
    record["speculative_f32"] = dict(
        layers=2, k=SPEC_K, prompt=SPEC_F32_PROMPT, new_tokens=SPEC_F32_NEW,
        drafts=runs)
    log("speculative f32 vs generate", json.dumps(record["speculative_f32"]))


def phase_forward_bf16(torch, port, record):
    """llama_7b widths, 2 layers, bf16, (1, 2048) tokens: logits through
    the tensor-core kernel against plain full attention (f32 no longer
    reaches that kernel)."""
    llama, convert, _, _, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict(), assign=True)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        a = flash_model(tokens).float()
        b = full_model(tokens).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(a).all()), "bf16 flash logits not finite")
    rms = ((a - b).norm() / b.norm()).item()
    record["forward_bf16_flash_vs_full"] = dict(
        layers=2, tokens=[1, 2048], rel_rms_err=rms,
        max_abs_err=(a - b).abs().max().item(),
        max_abs_want=b.abs().max().item(), tol=TOL_BF16_FLASH_VS_FULL)
    log("forward bf16 flash vs full", json.dumps(
        record["forward_bf16_flash_vs_full"]))
    check(rms <= TOL_BF16_FLASH_VS_FULL, f"bf16 flash vs full logits: {rms}")


def serve_prompts(torch, cfg) -> list:
    """The main path's 6 prompts, from the seed."""
    rng = torch.Generator().manual_seed(SEED + 2)
    return [torch.randint(1, cfg.vocab, (n,), generator=rng).tolist()
            for n in SERVE_LENS]


def phase_main_path(torch, fa, port, record):
    """The main path at full llama_7b size in bf16: the 32-layer flash
    forward on 2048 tokens, then the engine answering 6 requests.  After
    the launch counts are read, the same forward and 8 decode dispatches
    of the same engine traffic are traced for where the time goes.  Last,
    speculative decoding with an early-exit draft against generate() on
    one prompt (``speculative_bf16``)."""
    llama, convert, generate, serve, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.monotonic()
    model = convert.init_weights(cfg, gen)
    torch.cuda.synchronize()
    record["init_weights_s"] = time.monotonic() - t0
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)

    fa.flash_attention.launches = 0
    with torch.inference_mode():
        t0 = time.monotonic()
        logits = model(tokens)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
    forward_launches = fa.flash_attention.launches
    check(logits.shape == (1, 2048, cfg.vocab), "bf16 logits shape")
    check(bool(torch.isfinite(logits.float()).all()),
          "bf16 logits not finite")
    check(forward_launches == cfg.n_layers,
          f"flash launches {forward_launches} != {cfg.n_layers} layers")

    lens, new = SERVE_LENS, SERVE_NEW

    def engine():
        """A 4-slot engine holding the main path's 6 requests."""
        eng = serve.ServingEngine(model, max_slots=SERVE_SLOTS,
                                  max_len=max(lens) + new)
        for prompt in serve_prompts(torch, cfg):
            eng.submit(prompt, new)
        return eng

    eng = engine()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    main_launches = fa.flash_attention.launches
    check(len(done) == len(lens), "engine lost a request")
    check(all(len(c.tokens) == new for c in done), "short completion")
    check(all(0 <= t < cfg.vocab for c in done for t in c.tokens),
          "token out of vocabulary")
    ttft = [c.ttft_s for c in done]
    decode_tokens = eng.stats["tokens_out"] - eng.stats["prefills"]

    with torch.inference_mode():
        t_forward = cuda_ms(torch, lambda: model(tokens), iters=3,
                            warmup=1)
    record["main_path"] = dict(
        forward=dict(layers=cfg.n_layers, tokens=[1, 2048],
                     dtype="bfloat16", flash_launches=forward_launches,
                     first_call_s=first_s, ms=t_forward),
        # Six samples give no tail percentile (a nearest-rank p99 of 6
        # is the max), so the tail is reported as the max.
        serve=dict(card=record["card"], requests=len(lens),
                   prompt_lens=list(lens), new_tokens=new, max_slots=4,
                   wall_s=wall, ttft_p50_s=serve.nearest_rank(ttft, 0.50),
                   ttft_max_s=max(ttft),
                   decode_tokens=decode_tokens,
                   decode_s=eng.stats["decode_seconds"],
                   decode_tokens_per_s=(decode_tokens
                                        / eng.stats["decode_seconds"]),
                   decode_dispatches=eng.stats["decode_dispatches"],
                   pool_bytes=eng.pool_hbm_bytes()),
        flash_launches=main_launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    log("main path", json.dumps(record["main_path"]))

    with torch.inference_mode():
        forward_profile = device_profile(torch, lambda: model(tokens))
    eng = engine()
    eng.step()  # admits 4 of the 6 requests: all slots hold one

    def decode():
        for _ in range(8):
            eng.step()

    calls = forward_profile["port_kernel_calls"]
    check(calls["flash_fwd_mma_kernel"] == cfg.n_layers
          and calls["flash_fwd_kernel"] == 0,
          f"the bf16 forward ran the port's kernels {calls}, want the "
          f"tensor-core kernel {cfg.n_layers} times and the scalar one 0")
    record["profile"] = {"card": record["card"],
                         "forward_1x2048": forward_profile,
                         "decode_8_dispatches_4_slots":
                             device_profile(torch, decode)}
    for name, w in record["profile"].items():
        if name == "card":
            continue
        log(f"profile {name}: wall {w['wall_ms']:.2f} ms, device busy "
            f"{w['device_busy_ms']:.2f} ms ({w['device_busy_share']:.1%}),"
            f" {w['kernel_launches']} kernel launches;",
            "; ".join(f"{k['ms']:.3f} ms x{k['calls']} {k['name'][:40]}"
                      for k in w["top_kernels"]))
    speculative_bf16(torch, model, convert, generate, record)
    return main_launches


def speculative_bf16(torch, model, convert, generate, record):
    """speculative_generate on the 32-layer bf16 model with its first
    SPEC_DRAFT_LAYERS layers as the draft, against generate() on the same
    prompt: wall-clock tokens/s of each (median of SPEC_TIMED runs, the
    prefill included), the acceptance, the target forwards and the first
    position where the tokens differ.  Numbers only: no limit."""
    cfg = model.cfg
    rng = torch.Generator().manual_seed(SEED + 12)
    prompt = torch.randint(1, cfg.vocab, (1, SPEC_PROMPT), generator=rng)
    draft = convert.early_exit_draft(model, SPEC_DRAFT_LAYERS)

    def timed(fn):
        walls, out = [], None
        for _ in range(SPEC_TIMED):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        return out, sorted(walls)[len(walls) // 2], walls

    plain, plain_s, plain_walls = timed(
        lambda: generate.generate(model, prompt, SPEC_NEW))
    (spec, stats), spec_s, spec_walls = timed(
        lambda: generate.speculative_generate(model, draft, prompt,
                                              SPEC_NEW, k=SPEC_K))
    check(spec.shape == plain.shape == (1, SPEC_PROMPT + SPEC_NEW)
          and torch.equal(spec[:, :SPEC_PROMPT], plain[:, :SPEC_PROMPT]),
          f"speculative tokens {tuple(spec.shape)}")
    check(bool(((spec >= 0) & (spec < cfg.vocab)).all()),
          "speculative token out of vocabulary")
    differ = (spec[0, SPEC_PROMPT:] != plain[0, SPEC_PROMPT:]).nonzero()
    record["speculative_bf16"] = dict(
        card=record["card"], layers=cfg.n_layers,
        draft_layers=SPEC_DRAFT_LAYERS, k=SPEC_K, prompt=SPEC_PROMPT,
        new_tokens=SPEC_NEW, **stats,
        acceptance=stats["accepted"] / max(1, stats["drafted"]),
        first_difference=int(differ[0]) if len(differ) else None,
        generate_s=plain_s, speculative_s=spec_s,
        generate_walls_s=plain_walls, speculative_walls_s=spec_walls,
        generate_tokens_per_s=SPEC_NEW / plain_s,
        speculative_tokens_per_s=SPEC_NEW / spec_s)
    log("speculative bf16", json.dumps(record["speculative_bf16"]))


def phase_train_f32_parity(torch, port, record):
    """llama_7b widths, 2 layers, f32: loss and every grad, then a 4-step
    loss trajectory, through the flash kernels against full attention."""
    llama, convert, _, _, train = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              dtype="float32", attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict())
    # A batch a step: on one repeated batch the loss falls to ~1e-3 by
    # step 3, where a relative tolerance measures rounding, not the path.
    batches = [torch.randint(0, cfg.vocab, (2, 257), device="cuda",
                             generator=gen) for _ in range(4)]

    def loss_and_grads(model):
        loss = train.loss_fn(model, batches[0])
        return loss.item(), torch.autograd.grad(loss,
                                                list(model.parameters()))

    def trajectory(model):
        opt = train.make_optimizer()
        state = train.TrainState.for_model(model, opt)
        step = train.make_train_step(model, opt)
        return [step(state, tokens)[1].item() for tokens in batches]

    loss_f, grads_f = loss_and_grads(flash_model)
    loss_u, grads_u = loss_and_grads(full_model)
    grad_err = max(
        ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        for a, b in zip(grads_f, grads_u))
    del grads_f, grads_u
    traj_f = trajectory(flash_model)
    traj_u = trajectory(full_model)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj_f, traj_u))
    row = dict(layers=2, tokens=[2, 257], loss_flash=loss_f,
               loss_full=loss_u, loss_err=abs(loss_f - loss_u) / abs(loss_u),
               grad_err=grad_err, trajectory_flash=traj_f,
               trajectory_full=traj_u, trajectory_err=traj_err,
               tol_loss=TOL_TRAIN_LOSS, tol_grad=TOL_TRAIN_GRAD)
    record["train_f32_flash_vs_full"] = row
    log("train f32 flash vs full", json.dumps(row))
    check(all(map(math.isfinite, traj_f + traj_u)), "f32 losses not finite")
    check(row["loss_err"] <= TOL_TRAIN_LOSS, f"step-0 loss: {row}")
    check(grad_err <= TOL_TRAIN_GRAD, f"step-0 grads: {row}")
    check(traj_err <= TOL_TRAIN_LOSS, f"4-step trajectory: {row}")


def train_bf16_flash_vs_full(torch, llama, train, model, tokens, record):
    """The main path's model and batch: step-0 loss and every param grad
    through the flash kernels against plain full attention."""
    full = llama.Llama(dataclasses.replace(model.cfg, attention="full"),
                       device=model.device)
    full.load_state_dict(model.state_dict(), assign=True)  # shared weights

    def loss_and_grads(m):
        loss = train.loss_fn(m, tokens)
        return loss.item(), torch.autograd.grad(loss, list(m.parameters()))

    loss_f, grads_f = loss_and_grads(model)
    loss_u, grads_u = loss_and_grads(full)
    names = [n for n, _ in model.named_parameters()]
    rms = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, grads_f, grads_u)}
    worst = max(rms, key=rms.get)
    row = dict(layers=model.cfg.n_layers, tokens=list(tokens.shape),
               dtype="bfloat16", loss_flash=loss_f, loss_full=loss_u,
               loss_err=abs(loss_f - loss_u) / abs(loss_u),
               grad_rel_rms_err_max=rms[worst], worst_grad=worst,
               grad_rel_rms_err_median=statistics.median(rms.values()),
               tol_loss=TOL_BF16_LOSS, tol_grad_rms=TOL_BF16_GRAD_RMS)
    del full, grads_f, grads_u
    record["train_bf16_flash_vs_full"] = row
    log("train bf16 flash vs full", json.dumps(row))
    check(math.isfinite(loss_f) and row["loss_err"] <= TOL_BF16_LOSS,
          f"bf16 step-0 loss: {row}")
    check(rms[worst] <= TOL_BF16_GRAD_RMS, f"bf16 step-0 grads: {row}")


def phase_train_main(torch, fa, port, record):
    """The training path: llama_7b widths cut to 8 layers, bf16 with the
    f32 master copy, flash attention, 6 steps on one (1, 2049) batch; then
    3 steps from the same seed with the optimizer state offloaded."""
    llama, _, _, _, train = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=8,
                              attention="flash")
    tokens = torch.randint(
        0, cfg.vocab, (1, 2049), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    n_tokens = tokens.shape[1] - 1

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        return train.init_train_state(cfg, gen)

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    model, opt, state = fresh()
    train_bf16_flash_vs_full(torch, llama, train, model, tokens, record)
    step = train.make_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for f in counters:
        f.launches = 0
    # The largest tensor of the optimizer state (the last of the two
    # vocab-sized ones): after step 3 it shows that the offloaded state
    # is whole on the host as soon as the step returns.
    big = max(range(len(state.params)),
              key=lambda i: (state.params[i].numel(), i))
    for i in range(6):
        before = [f.launches for f in counters]
        t0 = time.monotonic()
        state, loss = step(state, tokens)
        losses.append(loss.item())  # waits for the step
        times.append(time.monotonic() - t0)
        per_step.append([f.launches - b for f, b in zip(counters, before)])
        if i == 2:
            nu_step3 = state.opt_state.nu[big].cpu()
    launches = [f.launches for f in counters]
    between = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"kernel launches per step {per_step}, want {cfg.n_layers} each")
    median = statistics.median(times[1:])
    main = dict(card=record["card"], layers=cfg.n_layers, params=n_params,
                tokens=[1, n_tokens + 1], dtype="bfloat16",
                master="float32", lr=opt.lr, losses=losses, step_s=times,
                median_step_s_2_to_6=median,
                tokens_per_s=n_tokens / median,
                launches_per_step=dict(zip(
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                    per_step[0])),
                peak_memory_bytes=peak, between_steps_bytes=between)
    log("train main path", json.dumps(main))
    record["train_profile"] = device_profile(
        torch, lambda: step(state, tokens), top=10)
    w = record["train_profile"]
    log(f"profile train step: wall {w['wall_ms']:.2f} ms, device busy "
        f"{w['device_busy_ms']:.2f} ms ({w['device_busy_share']:.1%}), "
        f"{w['kernel_launches']} kernel launches; by group (ms) "
        f"{json.dumps(w['ms_by_group'])};",
        "; ".join(f"{k['ms']:.3f} ms x{k['calls']} {k['name'][:40]}"
                  for k in w["top_kernels"]))
    check(w["port_kernel_calls"] == dict(
        flash_fwd_mma_kernel=cfg.n_layers, flash_fwd_kernel=0,
        flash_bwd_dq_mma_kernel=cfg.n_layers,
        flash_bwd_dkv_mma_kernel=cfg.n_layers,
        flash_bwd_dq_kernel=0, flash_bwd_dkv_kernel=0),
        f"the traced train step ran the port's kernels "
        f"{w['port_kernel_calls']}")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()

    model, opt, state = fresh()
    state = train.offload_state(state)
    step = train.OffloadedTrainStep(train.make_train_step(model, opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    off_losses, off_times = [], []
    for _ in range(3):
        t0 = time.monotonic()
        state, loss = step(state, tokens)  # waits for the host copy
        off_times.append(time.monotonic() - t0)
        # Read on the host before anything else waits for the card.
        host_state_whole = torch.equal(state.opt_state.nu[big], nu_step3)
        off_losses.append(loss.item())
    torch.cuda.synchronize()
    main["offloaded"] = dict(
        mode=step.mode, losses=off_losses, step_s=off_times,
        equal_bitwise=off_losses == losses[:3],
        host_state_equal_after_step_3=host_state_whole,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        between_steps_bytes=torch.cuda.memory_allocated(),
        opt_state_pinned=all(t.is_pinned() for t in state.opt_state.mu))
    main["offload_saves_bytes"] = (between
                                   - main["offloaded"]["between_steps_bytes"])
    record["train_main_path"] = main
    log("train offloaded", json.dumps(main["offloaded"]),
        f"saves {main['offload_saves_bytes'] / 1e9:.2f} GB between steps")
    check(main["offloaded"]["equal_bitwise"],
          f"offloaded losses {off_losses} != on-device {losses[:3]}")
    check(main["offloaded"]["opt_state_pinned"],
          "optimizer state not in pinned host memory")
    check(host_state_whole, "the host's optimizer state after step 3, read "
          "as the step returned, differs from the on-device step's")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def enforce_port():
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.models import convert, llama, train
    from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as fa
    from k8s_vgpu_scheduler_tpu_torch.shim import core, oversub
    return llama, convert, train, fa, core, oversub


def inventory(torch):
    """The card through TorchBackend, and the H100 fixture through the
    mock, side by side; needs no grant."""
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.tpulib import (
        H100_FIXTURE, MockBackend, TorchBackend)

    inv = TorchBackend().inventory()
    mock = MockBackend({**H100_FIXTURE, "mesh": [1]}).inventory()
    props = torch.cuda.get_device_properties(0)
    chip = inv.chips[0]
    smi_uuid = nvidia_smi("uuid")
    check(len(inv.chips) == 1, f"{len(inv.chips)} devices, want 1")
    check(chip.uuid == smi_uuid, f"uuid {chip.uuid} != nvidia-smi's "
          f"{smi_uuid}")
    check(chip.board.startswith(props.name), f"name {chip.board}")
    check(abs(chip.hbm_mib * MIB - props.total_memory)
          <= 0.01 * props.total_memory, f"memory {chip.hbm_mib} MiB")
    # Where cuBLAS's workspace comes from: what a first product allocates
    # beyond its output is drawn from the caching allocator (and counts
    # against a grant).
    a = torch.ones(256, 256, device="cuda", dtype=torch.bfloat16)
    before = torch.cuda.memory_allocated(0)
    b = a @ a
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated(0) - before - b.nbytes
    return dict(torch=[dataclasses.asdict(c) for c in inv.chips],
                torch_topology=dataclasses.asdict(inv.topology),
                mock=[dataclasses.asdict(c) for c in mock.chips],
                mock_topology=dataclasses.asdict(mock.topology),
                nvidia_smi_uuid=smi_uuid, total_memory=props.total_memory,
                sms=props.multi_processor_count,
                first_product_workspace_bytes=workspace)


def child_memory_cap(torch):
    """The inventory (before the shim comes up: it needs no grant); then,
    under a 24000 MiB grant, the virtual total, the 32-layer bf16 forward,
    256 MiB blocks until the allocator refuses, and the region's published
    use one watchdog interval later."""
    llama, convert, _, fa, core, _ = enforce_port()
    limit = ENFORCE_LIMIT_MIB * MIB
    t0 = time.monotonic()
    cards = inventory(torch)
    gc.collect()
    torch.cuda.empty_cache()
    times = {"inventory_s": time.monotonic() - t0}
    t0 = time.monotonic()
    shim = core.install()
    times["install_s"] = time.monotonic() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    info = shim.memory_info(0)
    check(info["total"] == limit, f"memory_info total {info['total']}")
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.monotonic()
    model = convert.init_weights(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)
    torch.cuda.synchronize()
    times["init_weights_s"] = time.monotonic() - t0
    out = []
    fa.flash_attention.launches = 0
    with torch.inference_mode():  # one forward: counted and traced
        profile = device_profile(torch, lambda: out.append(model(tokens)))
    launches = fa.flash_attention.launches
    logits = out.pop()
    check(launches == cfg.n_layers, f"flash launches {launches}")
    check(logits.shape == (1, 2048, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()), "capped logits")
    del logits
    times["forward_s"] = profile["wall_ms"] / 1e3
    calls = profile["port_kernel_calls"]
    check(calls["flash_fwd_mma_kernel"] == cfg.n_layers,
          f"the capped forward ran the port's kernels {calls}")
    peak_forward = torch.cuda.max_memory_reserved(0)
    blocks, refused_at = [], None
    for _ in range(limit // ENFORCE_BLOCK + 4):
        try:
            blocks.append(torch.empty(ENFORCE_BLOCK, dtype=torch.uint8,
                                      device="cuda"))
        except torch.cuda.OutOfMemoryError:
            refused_at = torch.cuda.memory_reserved(0)
            break
    check(refused_at is not None, f"{len(blocks)} blocks of 256 MiB past a "
          f"{ENFORCE_LIMIT_MIB} MiB grant raised no OutOfMemoryError")
    check(limit - 2 * ENFORCE_BLOCK <= refused_at <= limit,
          f"refused at {refused_at} reserved bytes, grant {limit}")
    time.sleep(1.5)  # the watchdog publishes once a second
    reserved = torch.cuda.memory_reserved(0)
    used = shim.native.read_region(
        os.environ["CUDA_DEVICE_MEMORY_SHARED_CACHE"])["used"][0]
    check(abs(used - reserved) <= TOL_USED * reserved,
          f"region used {used} against reserved {reserved}")
    free, card_total = torch.cuda.mem_get_info(0)
    outside = card_total - free - reserved - int(os.environ["PARENT_USED"])
    return dict(inventory=cards, times=times,
                limit=limit, total_memory=total, fraction=limit / total,
                memory_info_total=info["total"], flash_launches=launches,
                profile_flash_fwd_mma_calls=calls["flash_fwd_mma_kernel"],
                forward_peak_reserved=peak_forward,
                blocks_before_refusal=len(blocks),
                reserved_at_refusal=refused_at,
                grant_minus_reserved_at_refusal=limit - refused_at,
                region_used=used, reserved_when_read=reserved,
                outside_allocator_bytes=outside)


def child_load_oom(torch):
    """Under an 8000 MiB grant the 13.5 GB of weights cannot load: the
    allocator must refuse while they do."""
    llama, convert, _, _, core, _ = enforce_port()
    limit = ENFORCE_SMALL_LIMIT_MIB * MIB
    t0 = time.monotonic()
    core.install()
    install_s = time.monotonic() - t0
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    t0 = time.monotonic()
    try:
        convert.init_weights(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED + 1))
        refused_at = None
    except torch.cuda.OutOfMemoryError:
        refused_at = torch.cuda.memory_reserved(0)
    load_s = time.monotonic() - t0
    check(refused_at is not None,
          f"13.5 GB of weights loaded under a {ENFORCE_SMALL_LIMIT_MIB} MiB "
          "grant")
    check(refused_at <= limit, f"reserved {refused_at} past the grant")
    return dict(limit=limit, reserved_at_refusal=refused_at,
                install_s=install_s, load_until_refused_s=load_s)


def enforce_train_state(torch, llama, train, n_layers: int = 8):
    """phase_train_main's model and batch: llama_7b widths, 8 layers,
    bf16 with the f32 master copy, one (1, 2049) batch."""
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=n_layers,
                              attention="flash")
    tokens = torch.randint(
        0, cfg.vocab, (1, 2049), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    model, opt, state = train.init_train_state(cfg, gen)
    return cfg, tokens, model, state, train.make_train_step(model, opt)


def host_swap(torch, core, oversub, state) -> dict:
    """The train state's AdamW state through HostSwapStore: suspend must
    free its bytes; then a dispatch that takes the state must find it on
    the card again (the gate brings it back), bit for bit."""
    tree = {"mu": state.opt_state.mu, "nu": state.opt_state.nu}
    leaves = oversub.tree_leaves(tree)
    nbytes = oversub.tree_bytes(tree)
    kept = [t.clone() for t in leaves]
    store = oversub.global_store()
    store.register("adamw", tree)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(0)
    t0 = time.monotonic()
    freed = store.suspend("adamw")
    suspend_s = time.monotonic() - t0
    after = torch.cuda.memory_allocated(0)
    pinned = all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
    t0 = time.monotonic()
    core.gate(lambda state: None, state)
    resume_s = time.monotonic() - t0
    on_card = all(t.is_cuda for t in leaves)
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(leaves, kept))
    check(abs((before - after) - nbytes) <= TOL_SWAP_BYTES * nbytes,
          f"suspend freed {before - after} bytes of a {nbytes}-byte state")
    check(freed == nbytes and pinned and on_card and bitwise,
          f"freed {freed}, pinned {pinned}, back on the card {on_card}, "
          f"bitwise {bitwise}")
    return dict(state_bytes=nbytes, allocated_before=before,
                allocated_suspended=after, freed=before - after,
                suspend_s=suspend_s, resume_s=resume_s, host_pinned=pinned,
                resumed_bitwise=bitwise)


def child_train(torch):
    """2 warm-up and 8 timed train steps, each one dispatch of the gate
    (VTPU_SYNC_EVERY=1), capped or not by the env: per step its device
    time (CUDA events inside the gate), its wall time and the cost the
    gate charged; the duty is device time over wall time.  Where the grant
    oversubscribes, the AdamW state goes through host swap after the
    warm-up (host_swap), so the timed steps' losses are those after a
    suspend and resume."""
    llama, _, train, fa, core, oversub = enforce_port()
    shim = core.install()
    cfg, tokens, model, state, step = enforce_train_state(torch, llama, train)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in counters:
        f.launches = 0
    losses, per_step = [], []

    def launches():
        return [f.launches for f in counters]

    for _ in range(2):  # through the step callable's own gate
        n0, before = shim.dispatches, launches()
        state, loss = step(state, tokens)
        losses.append(loss.item())
        check(shim.dispatches == n0 + 1, "the train step was not one "
              "dispatch of the gate")
        per_step.append([a - b for a, b in zip(launches(), before)])
    swap = host_swap(torch, core, oversub, state) \
        if oversub.enabled_from_env() else None
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(8)]
    step_s, charged_us = [], []
    t_start = time.monotonic()
    for start, end in events:
        def timed(state, tokens):
            start.record()
            out = step(state, tokens)  # nested: part of this dispatch
            end.record()
            return out

        before = launches()
        t0 = time.monotonic()
        state, loss = core.gate(timed, state, tokens)
        step_s.append(time.monotonic() - t0)
        charged_us.append(shim.last_cost_us[0])
        losses.append(loss.item())
        per_step.append([a - b for a, b in zip(launches(), before)])
    wall_s = time.monotonic() - t_start
    torch.cuda.synchronize()
    busy_ms = [a.elapsed_time(b) for a, b in events]
    duty = sum(busy_ms) / (wall_s * 1e3)
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"kernel launches per step {per_step}")
    for ms, us in zip(busy_ms, charged_us):
        check(abs(us / 1e3 - ms) <= TOL_CHARGED * ms,
              f"charged {us} us for a step of {ms:.3f} device ms")
    return dict(sm_limit=int(shim.native.lib.vgpu_get_sm_limit(0)),
                policy=os.environ.get("GPU_CORE_UTILIZATION_POLICY"),
                losses=losses, step_s=step_s,
                median_step_s=statistics.median(step_s),
                device_ms=busy_ms, charged_us=charged_us, wall_s=wall_s,
                duty=duty, dispatches=shim.dispatches, host_swap=swap,
                launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), launches())))


def child_interposer_swap(torch):
    """Host swap under the interposer, installed by this process:
    interposer_swap's body after ``core.install()``, on the 8-layer
    step."""
    _, _, _, _, core, _ = enforce_port()
    return interposer_swap(torch, core.install())


def child_preempt_swap(torch):
    """phase_preempt's H: interposer_swap's body in a pod started with the
    env and mounts of its Allocate alone, which never calls install().
    The shim's startup hook must have installed it as this process
    imported its port (``core._GLOBAL`` set by the import), into the
    port beside this script, not a copy in the shim dir; install() is
    then made to fail, so nothing here installs it."""
    _, _, _, _, core, _ = enforce_port()
    shim = core._GLOBAL
    check(shim is not None, "the startup hook did not install the shim")
    check(Path(core.__file__).resolve()
          == ROOT / "k8s_vgpu_scheduler_tpu_torch" / "shim" / "core.py",
          f"the shim installed is {core.__file__}, not this checkout's")

    def install(*args, **kwargs):
        raise Fail("install() was called in a pod the hook set up")

    core.install = install
    out = interposer_swap(torch, shim, PREEMPT_LAYERS)
    out["shim_source"] = core.__file__
    out["pythonpath"] = os.environ.get("PYTHONPATH")
    return out


def interposer_swap(torch, shim, n_layers: int = 8):
    """Host swap under the interposer (an oversubscribed grant,
    ``CUDA_OVERSUBSCRIBE=true``): ``shim`` must have the spiller and the
    spill-only gate, and the limiter must never be called.  The
    ``n_layers``-layer train step, 2 warm-up steps, then pressure.  With the AdamW
    state registered, an allocation outside the gate takes what the
    interposer charges SWAP_OVER_MIB past the spiller's pressure point
    (the grant less the headroom), while the allocated bytes and the
    headroom stay below the grant: only a reading of the charge spills.
    A dispatch that holds nothing must spill the state at its gate, and
    the bytes it frees are read as the interposer's charge (the region's
    ``used``) and as nvidia-smi's card reading.  A dispatch then takes
    half the state's bytes, which the grant holds only with the state
    spilled, and the next dispatch that takes the state must find it on
    the card bit for bit; no allocation may be refused throughout.  Then
    INTERPOSER_SWAP_STEPS more steps, whose losses go beside the
    unswapped interposed run's."""
    llama, _, train, fa, core, oversub = enforce_port()
    spiller = shim._spiller
    check(shim.interposed and shim.native.interposed
          and spiller is not None and core._GATE is shim
          and not shim.fractions,
          "install() under the interposer with CUDA_OVERSUBSCRIBE: no "
          "spiller, or a memory fraction")
    lib, limiter = shim.native.lib, []
    for name in ("vgpu_rate_acquire", "vgpu_rate_feedback"):
        setattr(lib, name, (lambda real, name: lambda *a: (
            limiter.append(name), real(*a))[1])(getattr(lib, name), name))
    cfg, tokens, model, state, step = enforce_train_state(torch, llama, train,
                                                         n_layers)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in counters:
        f.launches = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(loss.item())

    def read():
        torch.cuda.synchronize()
        return dict(region_used=int(lib.vgpu_get_used(0)),
                    smi=smi_card_mib() * MIB)

    tree = {"mu": state.opt_state.mu, "nu": state.opt_state.nu}
    leaves = oversub.tree_leaves(tree)
    n = oversub.tree_bytes(tree)
    kept = [t.clone() for t in leaves]
    oversub.global_store().register("adamw", tree)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    refusals = interposer_stats()["refusals"]
    [(_, charged, grant)] = spiller.sample()
    fill = grant - charged - spiller.headroom + SWAP_OVER_MIB * MIB
    check(fill > 0, f"the state's charge {charged} is already past the "
          f"pressure point of a {grant}-byte grant")
    ballast = torch.empty(fill, dtype=torch.uint8, device="cuda")
    pressure = dict(grant=grant, charged=charged, ballast=fill,
                    allocated=torch.cuda.memory_allocated(0),
                    headroom=spiller.headroom,
                    charged_at_gate=spiller.sample()[0][1])
    check(pressure["allocated"] + spiller.headroom < grant,
          f"the allocated bytes alone reach the pressure point: {pressure}")
    before = read()
    t0 = time.monotonic()
    core.gate(lambda: None)  # holds nothing: the pressure spills the state
    suspend_s = time.monotonic() - t0
    during = read()
    spilled = all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
    room = core.gate(lambda: torch.empty(n // 2, dtype=torch.uint8,
                                         device="cuda"))
    del room, ballast
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    core.gate(lambda state: None, state)
    resume_s = time.monotonic() - t0
    on_card = all(t.is_cuda for t in leaves)
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(leaves, kept))
    del kept
    pressure["refusals"] = interposer_stats()["refusals"] - refusals
    check(spilled and on_card and bitwise and not pressure["refusals"],
          f"spilled at the gate {spilled}, back on the card {on_card}, "
          f"bitwise {bitwise}, refusals {pressure['refusals']}")
    freed = {k: before[k] - during[k] for k in before}
    for what, got in freed.items():
        check(abs(got - n) <= TOL_SWAP_BYTES * n,
              f"the spill under the interposer freed {got} bytes by {what}, "
              f"the state is {n}")
    for _ in range(INTERPOSER_SWAP_STEPS):
        state, loss = step(state, tokens)
        losses.append(loss.item())
    check(not limiter and not shim.last_cost_us and shim.dispatches == 0,
          f"the limiter ran under the interposer: {limiter[:4]}")
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    return dict(losses=losses, freed=freed, limiter_calls=len(limiter),
                pressure=pressure,
                host_swap=dict(state_bytes=n, suspend_s=suspend_s,
                               resume_s=resume_s, resumed_bitwise=bitwise),
                interposer=interposer_stats(),
                launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"),
                                  [f.launches for f in counters])))


def stats_reader():
    """A reader of the preloaded interposer's counters on device 0, bound
    once: the co-residency children read it after every step."""
    import ctypes

    fn = ctypes.CDLL(None).vgpu_interposer_stats
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    out = (ctypes.c_uint64 * len(INTERPOSER_STATS))()

    def read() -> dict:
        n = fn(0, out, len(out))
        return dict(zip(INTERPOSER_STATS, out[:n]))

    return read


def interposer_stats() -> dict:
    """The preloaded interposer's counters on device 0."""
    return stats_reader()()


def stood_down(core) -> dict:
    """Install the shim as a container's startup would, and check that it
    stood down for the interposer: no fraction, no gate, no publishing."""
    shim = core.install()
    check(core.interposer_active() and shim.interposed
          and shim.native.interposed and core._GATE is None
          and not shim.fractions,
          "the Python shim did not stand down under the interposer")
    return shim


def check_grant(smi: int, grant_mib: int, what: str) -> None:
    """nvidia-smi's reading at a refusal: at most the grant, within
    TOL_GRANT_MIB of it."""
    check(grant_mib - TOL_GRANT_MIB <= smi <= grant_mib,
          f"{what}: nvidia-smi reads {smi} MiB at the refusal, grant "
          f"{grant_mib} MiB")


def child_interposer_cap(torch):
    """Under a 24000 MiB grant through the interposer alone: the shim stands
    down, the virtual total, the 32-layer bf16 forward, then 256 MiB blocks
    until torch.OutOfMemoryError, read by nvidia-smi (the context
    included) and from the region at the refusal.  What the card holds
    beyond the charged allocations is the process's footprint, which the
    fixed context charge must cover, by at most TOL_CONTEXT_MIB more."""
    llama, convert, _, fa, core, _ = enforce_port()
    limit = ENFORCE_LIMIT_MIB * MIB
    baseline = smi_card_mib()  # before this process brings CUDA up
    shim = stood_down(core)
    free, total = torch.cuda.mem_get_info(0)
    check(total == limit, f"mem_get_info total {total}, grant {limit}")
    after_init = interposer_stats()
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = convert.init_weights(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        logits = model(tokens)
        torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    check(launches == cfg.n_layers, f"flash launches {launches}")
    check(logits.shape == (1, 2048, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()), "capped logits")
    del logits
    blocks, refused = [], False
    for _ in range(limit // ENFORCE_BLOCK + 4):
        try:
            blocks.append(torch.empty(ENFORCE_BLOCK, dtype=torch.uint8,
                                      device="cuda"))
        except torch.cuda.OutOfMemoryError:
            refused = True
            break
    torch.cuda.synchronize()
    smi = smi_card_mib() - baseline
    used = int(shim.native.lib.vgpu_get_used(0))
    reserved = torch.cuda.memory_reserved(0)
    stats = interposer_stats()
    check(refused, f"{len(blocks)} blocks of 256 MiB past a "
          f"{ENFORCE_LIMIT_MIB} MiB grant raised no OutOfMemoryError")
    check_grant(smi, ENFORCE_LIMIT_MIB, f"one process (card {baseline} MiB "
                f"before, region used {used})")
    check(abs(used - smi * MIB) <= TOL_USED * smi * MIB,
          f"region used {used} against nvidia-smi's {smi} MiB")
    footprint = smi * MIB - stats["alloc_bytes"]
    check(0 <= stats["context_bytes"] - footprint <= TOL_CONTEXT_MIB * MIB,
          f"context charged {stats['context_bytes']} bytes, the card shows "
          f"{footprint} outside the allocations")
    return dict(limit=limit, mem_get_info_total=total,
                mem_get_info_free=free,
                device_total_memory=torch.cuda.get_device_properties(0)
                .total_memory,
                flash_launches=launches, blocks_before_refusal=len(blocks),
                smi_used_mib_at_refusal=smi,
                grant_minus_smi_mib=ENFORCE_LIMIT_MIB - smi,
                region_used_at_refusal=used, reserved_at_refusal=reserved,
                smi_baseline_mib=baseline,
                context_bytes=stats["context_bytes"],
                context_bytes_at_init=after_init["context_bytes"],
                footprint_bytes=footprint,
                alloc_bytes=stats["alloc_bytes"],
                refusals=stats["refusals"], interposer=stats)


def wait_for(path: Path, what: str) -> None:
    t0 = time.monotonic()
    while not path.exists():
        check(time.monotonic() - t0 < 120, f"no {what}")
        time.sleep(0.01)


def child_interposer_pod(torch):
    """One of two processes of one pod (one region, one 24000 MiB grant):
    bring CUDA up at the same time as the other, while a co-tenant outside
    the pod allocates and frees; once the co-tenant is gone, take 256 MiB
    blocks at the same time as the other until refused, and hold them until
    the parent has read the card."""
    pod = Path(os.environ["POD_DIR"])
    me = int(os.environ["POD_INDEX"])
    wait_for(pod / "churning", f"pod {me}: co-tenant")
    ctx_start = time.monotonic()  # one clock for every process of the host
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ctx_end = time.monotonic()
    (pod / f"ready{me}").touch()
    wait_for(pod / "blocks", f"pod {me}: the parent's go")
    blocks, refused = [], False
    for _ in range(ENFORCE_LIMIT_MIB * MIB // ENFORCE_BLOCK + 4):
        try:
            blocks.append(torch.empty(ENFORCE_BLOCK, dtype=torch.uint8,
                                      device="cuda"))
        except torch.cuda.OutOfMemoryError:
            refused = True
            break
    torch.cuda.synchronize()
    (pod / f"refused{me}").touch()
    wait_for(pod / "release", f"pod {me}: release")
    check(refused, f"pod {me}: {len(blocks)} blocks and no refusal")
    return dict(blocks=len(blocks), reserved=torch.cuda.memory_reserved(0),
                ctx_window_s=[ctx_start, ctx_end],
                interposer=interposer_stats())


def child_cotenant(torch):
    """A process outside the pod (no interposer, no region): allocates and
    frees COTENANT_BLOCK, back to the driver each time, until the parent
    says stop; the pod's contexts come up meanwhile."""
    pod = Path(os.environ["POD_DIR"])
    times = []
    while not (pod / "stop_cotenant").exists():
        x = torch.empty(COTENANT_BLOCK, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        del x
        torch.cuda.empty_cache()
        times.append(time.monotonic())
        if len(times) == 1:
            (pod / "churning").touch()
        check(len(times) < 10 ** 6, "the co-tenant was never stopped")
    return dict(cycles=len(times), first_s=times[0], last_s=times[-1])


def child_plain_torch(torch):
    """A process that imports torch and nothing of the port, under an 8000
    MiB grant the interposer alone enforces: 256 MiB blocks until refused,
    read by nvidia-smi."""
    port = sorted(m for m in sys.modules if m.startswith("k8s_vgpu"))
    check(not port, f"the plain child imported {port}")
    baseline = smi_card_mib()  # before this process brings CUDA up
    free, total = torch.cuda.mem_get_info(0)
    blocks = []
    try:
        while len(blocks) < 1000:
            blocks.append(torch.empty(ENFORCE_BLOCK, dtype=torch.uint8,
                                      device="cuda"))
        check(False, "1000 blocks of 256 MiB and no refusal")
    except torch.cuda.OutOfMemoryError:
        pass
    torch.cuda.synchronize()
    smi = smi_card_mib() - baseline
    check_grant(smi, ENFORCE_SMALL_LIMIT_MIB, "a process that imports only "
                "torch")
    return dict(limit=ENFORCE_SMALL_LIMIT_MIB * MIB, mem_get_info_total=total,
                blocks_before_refusal=len(blocks),
                smi_used_mib_at_refusal=smi, smi_baseline_mib=baseline,
                reserved_at_refusal=torch.cuda.memory_reserved(0),
                port_modules=port)


def child_oci_pod(torch):
    """A process started from a bundle that vgpu-oci-runtime injected
    (phase_device_plugin's oci_leg), importing torch and nothing of the
    port: the image's module on its own PYTHONPATH entry, after the
    injected shim dir; then 256 MiB blocks until refused, read by
    nvidia-smi and by the preloaded interposer's region."""
    import ctypes
    import importlib

    probe = importlib.import_module(OCI_PROBE)
    hook = sys.modules.get("sitecustomize")
    baseline = smi_card_mib()  # before this process brings CUDA up
    free, total = torch.cuda.mem_get_info(0)
    blocks = []
    try:
        while len(blocks) < 1000:
            blocks.append(torch.empty(ENFORCE_BLOCK, dtype=torch.uint8,
                                      device="cuda"))
        check(False, "1000 blocks of 256 MiB and no refusal")
    except torch.cuda.OutOfMemoryError:
        pass
    torch.cuda.synchronize()
    smi = smi_card_mib() - baseline
    get_used = ctypes.CDLL(None).vgpu_get_used
    get_used.argtypes, get_used.restype = [ctypes.c_int], ctypes.c_uint64
    port = sorted(m for m in sys.modules if m.startswith("k8s_vgpu"))
    check(not port, f"the OCI pod imported {port}")
    return dict(mem_get_info_total=total, mem_get_info_free=free,
                blocks_before_refusal=len(blocks),
                smi_used_mib_at_refusal=smi, smi_baseline_mib=baseline,
                region_used_at_refusal=int(get_used(0)),
                pythonpath=os.environ.get("PYTHONPATH"),
                sys_path=sys.path, probe=probe.__file__,
                hook=getattr(hook, "__file__", None),
                ld_preload=os.environ.get("LD_PRELOAD"), port_modules=port)


def child_interposer_train(torch):
    """The 8-layer bf16 train step with nothing in its way but what the env
    preloads: the shim, if installed, stands down (no gate: the step
    callables run as plain calls).  2 warm-up steps, 8 timed ones (CUDA
    events around each, host wall), then INTERPOSER_STEPS_TRACED traced
    ones whose kernels' device
    time is a step's busy time: events around a throttled step would count
    the throttle's sleeps inside it.  The duty is that busy time, times the
    8 steps, over their wall."""
    llama, _, train, fa, core, _ = enforce_port()
    preloaded = "LD_PRELOAD" in os.environ
    if preloaded:
        stood_down(core)
    cfg, tokens, model, state, step = enforce_train_state(torch, llama, train)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in counters:
        f.launches = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(loss.item())
    torch.cuda.synchronize()
    before = interposer_stats() if preloaded else None
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(8)]
    step_s = []
    t_start = time.monotonic()
    for start, end in events:
        t0 = time.monotonic()
        start.record()
        state, loss = step(state, tokens)
        end.record()
        losses.append(loss.item())
        step_s.append(time.monotonic() - t0)
    wall_s = time.monotonic() - t_start
    after = interposer_stats() if preloaded else None
    event_ms = [a.elapsed_time(b) for a, b in events]
    out = []

    def traced():
        nonlocal state
        for _ in range(INTERPOSER_STEPS_TRACED):
            state, loss = step(state, tokens)
            out.append(loss.item())

    profile = device_profile(torch, traced)
    losses += out
    busy_ms = profile["device_busy_ms"] / INTERPOSER_STEPS_TRACED
    steps = 10 + INTERPOSER_STEPS_TRACED
    launches = [f.launches for f in counters]
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(launches == [cfg.n_layers * steps] * 3,
          f"flash launches {launches} in {steps} steps")
    calls = profile["port_kernel_calls"]
    check(all(calls[k] == cfg.n_layers * INTERPOSER_STEPS_TRACED
              for k in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                        "flash_bwd_dkv_mma_kernel")),
          f"the traced steps ran the port's kernels {calls}")
    timed = dict(
        preloaded=preloaded,
        sm_limit=os.environ.get("CUDA_DEVICE_SM_LIMIT"),
        policy=os.environ.get("GPU_CORE_UTILIZATION_POLICY"),
        losses=losses, step_s=step_s,
        median_step_s=statistics.median(step_s), event_ms=event_ms,
        wall_s=wall_s, busy_ms_per_step=busy_ms,
        duty=busy_ms * len(events) / (wall_s * 1e3),
        traced_wall_ms=profile["wall_ms"],
        traced_busy_share=profile["device_busy_share"],
        profiler_launches_per_step=profile["kernel_launches"]
        / INTERPOSER_STEPS_TRACED,
        launches=dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                          launches)))
    if preloaded:
        delta = {k: after[k] - before[k] for k in after}
        timed.update(
            interposer=after,
            hooked_launches_per_step=delta["launches"] / len(events),
            charged_us_per_step=delta["charged_us"] / len(events),
            charged_over_busy=delta["charged_us"] / 1e3
            / (busy_ms * len(events)))
    return timed


def grant_env() -> dict:
    """This process's grant keys (GRANT_ENV) as its env holds them."""
    return {k: v for k, v in os.environ.items() if k.startswith(GRANT_ENV)}


def child_cores_train(torch):
    """Pod T of phase_coresidency: the 8-layer bf16 train step through the
    interposer (the shim stands down), 2 warm-up steps, then steps without
    pause until the parent says stop.  Each step's start and end
    (time.monotonic(), one clock for every process of the host), loss,
    CUDA-event device time and the interposer's charged µs after it.  When
    the parent asks (``trace_<name>``), INTERPOSER_STEPS_TRACED steps run
    under torch.profiler for their kernel time."""
    llama, _, train, fa, core, _ = enforce_port()
    ctl = Path(os.environ["CORES_DIR"])
    stood_down(core)
    stats = stats_reader()
    cfg, tokens, model, state, step = enforce_train_state(torch, llama, train)
    mem_total = torch.cuda.mem_get_info()[1]
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in counters:
        f.launches = 0
    steps, events, traces = [], [], {}

    def one(traced=None):
        nonlocal state
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        start.record()
        state, loss = step(state, tokens)
        end.record()
        value = loss.item()
        steps.append(dict(start=t0, end=time.monotonic(), loss=value,
                          charged_us=stats()["charged_us"], traced=traced))
        events.append((start, end))

    for _ in range(2):
        one()
    (ctl / "train_ready").touch()
    while not (ctl / "train_stop").exists():
        asked = [n for n in ("solo", "shared")
                 if (ctl / f"trace_{n}").exists() and n not in traces]
        if not asked:
            one()
            check(len(steps) < 10 ** 5, "the train pod was never stopped")
            continue
        t0 = time.monotonic()
        prof = device_profile(torch, lambda: [
            one(asked[0]) for _ in range(INTERPOSER_STEPS_TRACED)])
        traces[asked[0]] = dict(
            span=[t0, time.monotonic()], wall_ms=prof["wall_ms"],
            busy_ms_per_step=prof["device_busy_ms"] / INTERPOSER_STEPS_TRACED,
            busy_share=prof["device_busy_share"],
            port_kernel_calls=prof["port_kernel_calls"])
        (ctl / f"traced_{asked[0]}").touch()
    torch.cuda.synchronize()
    for s, (a, b) in zip(steps, events):
        s["event_ms"] = a.elapsed_time(b)
    launches = [f.launches for f in counters]
    check(all(math.isfinite(s["loss"]) for s in steps), "a loss not finite")
    check(launches == [cfg.n_layers * len(steps)] * 3,
          f"flash launches {launches} in {len(steps)} steps")
    return dict(steps=steps, traces=traces, interposer=stats(),
                losses=[s["loss"] for s in steps], end_t=time.monotonic(),
                launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), launches)),
                mem_total=mem_total, grant_env=grant_env())


def child_cores_serve(torch):
    """Pod S of phase_coresidency: the 32-layer bf16 llama_7b behind a
    4-slot ServingEngine (its prefill and decode attend through the KV
    cache, as the JAX engine's do: no flash kernel).  One wave is the main path's 6 requests,
    submitted at once (a deterministic schedule).  After loading and one
    warm-up wave it says ready and waits for the parent's go; then waves
    back to back for each burst of ``CORES_BURSTS`` (seconds), idle
    CORES_IDLE_S between bursts.  Through the interposer when the env
    preloads it, else with nothing in its way."""
    llama, convert, _, fa, core, _ = enforce_port()
    from k8s_vgpu_scheduler_tpu_torch.models import serve

    ctl = Path(os.environ["CORES_DIR"])
    name = os.environ["CORES_NAME"]
    preloaded = "LD_PRELOAD" in os.environ
    if preloaded:
        stood_down(core)
    stats = stats_reader() if preloaded else dict
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    t0 = time.monotonic()
    model = convert.init_weights(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 1))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    mem_total = torch.cuda.mem_get_info()[1]
    prompts = serve_prompts(torch, cfg)

    def wave() -> dict:
        start = time.monotonic()  # before the wave's first launch
        eng = serve.ServingEngine(model, max_slots=SERVE_SLOTS,
                                  max_len=max(SERVE_LENS) + SERVE_NEW)
        ids = [eng.submit(p, SERVE_NEW) for p in prompts]
        done = {c.request_id: c for c in eng.run()}
        check(sorted(done) == sorted(ids), f"{name}: the engine lost a "
              "request")
        return dict(start=start, end=time.monotonic(),
                    tokens=[done[i].tokens for i in ids],
                    ttft_s=[done[i].ttft_s for i in ids],
                    decode_tokens=eng.stats["tokens_out"]
                    - eng.stats["prefills"],
                    decode_s=eng.stats["decode_seconds"],
                    decode_dispatches=eng.stats["decode_dispatches"])

    warm = wave()
    (ctl / f"{name}_ready").touch()
    wait_for(ctl / f"{name}_go", f"{name}: the parent's go")
    bursts = []
    for b, burst_s in enumerate(map(float,
                                    os.environ["CORES_BURSTS"].split(","))):
        if b:
            time.sleep(CORES_IDLE_S)
        (ctl / f"{name}_burst{b}").touch()
        before = stats()
        waves = [wave()]
        while time.monotonic() - waves[0]["start"] < burst_s:
            waves.append(wave())
        after = stats()
        bursts.append(dict(start=waves[0]["start"], end=waves[-1]["end"],
                           waves=waves, interposer={
                               k: after[k] - before[k] for k in after}))
    tokens = [w["tokens"] for b in bursts for w in b["waves"]]
    check(all(t == warm["tokens"] for t in tokens),
          f"{name}: the waves' tokens differ from each other")
    check(all(0 <= t < cfg.vocab for w in tokens for c in w for t in c),
          f"{name}: a token out of vocabulary")
    # The engine prefills through the KV-cache path, as the JAX engine
    # does: the port's kernels are T's.
    check(fa.flash_attention.launches == 0,
          f"{name}: the engine launched the flash kernel")
    return dict(preloaded=preloaded, init_s=init_s, warm=warm,
                bursts=bursts, tokens=warm["tokens"],
                interposer=stats(), end_t=time.monotonic(),
                mem_total=mem_total, grant_env=grant_env())


def child_preempt(torch):
    """One pod of phase_preempt: the PREEMPT_LAYERS-layer bf16 train step
    (f32 master) through the interposer under PREEMPT_MIB, driven by
    run_preemptible for PREEMPT_STEPS on one batch, with a CheckpointManager on
    PREEMPT_DIR, stopping on a PreemptionWatch of its own annotations file
    (VTPU_PODINFO_ANNOTATIONS).  Prints ``STEP <n>`` once step n has
    finished on the card (its loss read back)."""
    llama, _, train, fa, core, _ = enforce_port()
    from k8s_vgpu_scheduler_tpu_torch.models.checkpoint import (
        CheckpointManager)
    from k8s_vgpu_scheduler_tpu_torch.shim.preempt import PreemptionWatch

    stood_down(core)
    cfg, tokens, model, state, step = enforce_train_state(
        torch, llama, train, PREEMPT_LAYERS)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for f in counters:
        f.launches = 0
    io = {"saves": [], "restores": []}

    class Timed(CheckpointManager):
        def save(self, step, state, wait=False):
            t0 = time.monotonic()
            super().save(step, state, wait)
            io["saves"].append(dict(step=step, s=time.monotonic() - t0,
                                    bytes=os.path.getsize(self.path(step)),
                                    end_t=time.monotonic()))

        def restore(self, state_like, step=None):
            t0 = time.monotonic()
            out = super().restore(state_like, step)
            torch.cuda.synchronize()
            io["restores"].append(dict(
                step=state_like.step, s=time.monotonic() - t0,
                bytes=os.path.getsize(self.path(state_like.step))))
            return out

    watch = PreemptionWatch()
    seen = []

    def should_stop() -> bool:
        if not watch.requested():
            return False
        seen.append(time.monotonic())
        return True

    losses = []

    def logged(state, tokens):
        state, loss = step(state, tokens)
        losses.append(loss.item())
        print(f"STEP {state.step}", flush=True)
        return state, loss

    mgr = Timed(os.environ["PREEMPT_DIR"])
    t0 = time.monotonic()
    state, done, preempted = train.run_preemptible(
        logged, state, tokens, PREEMPT_STEPS, mgr, should_stop)
    torch.cuda.synchronize()
    launches = [f.launches for f in counters]
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(launches == [cfg.n_layers * len(losses)] * 3,
          f"flash launches {launches} in {len(losses)} steps")
    return dict(done=done, preempted=preempted,
                first_step=done - len(losses) + 1, losses=losses,
                requester=watch.requester(),
                stop_seen_t=seen[0] if seen else None,
                run_s=time.monotonic() - t0, io=io,
                peak_allocated=torch.cuda.max_memory_allocated(),
                interposer=interposer_stats(), exit_t=time.monotonic(),
                launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), launches)))


def child_quota_pod(torch):
    """phase_preempt's B: a borrowed grant's pod, under the env of its
    Allocate answer (the interposer preloaded), launching a loop of
    matmuls on the card and printing ``LOOP <n>`` after each pass, until
    a PreemptionWatch of its own annotations file sees the eviction
    request; then it exits 0, as a checkpointed pod does."""
    from k8s_vgpu_scheduler_tpu_torch.shim.preempt import PreemptionWatch

    watch = PreemptionWatch()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn(2048, 2048, device="cuda", generator=gen)
    t0, loops = time.monotonic(), 0
    while not watch.requested():
        check(time.monotonic() - t0 < QUOTA_POD_S,
              f"no eviction request in {QUOTA_POD_S} s")
        for _ in range(16):
            x = torch.tanh(x @ x / 2048 ** 0.5)
        torch.cuda.synchronize()
        loops += 1
        print(f"LOOP {loops}", flush=True)
    seen = time.monotonic()
    check(bool(torch.isfinite(x).all()), "B's loop is not finite")
    return dict(loops=loops, requester=watch.requester(), stop_seen_t=seen,
                interposer=interposer_stats(), exit_t=time.monotonic())


def child_gang_member(torch):
    """One member of phase_preempt's gang (GangLeg), under the env of its
    Allocate answer (the interposer preloaded): it joins the gang's
    process group from that env alone (``multihost.initialize_from_env``;
    gloo over CPU tensors: NCCL refuses two ranks on one card, and a real
    multi-card gang passes "nccl"), launches the flash forward kernel in
    bf16 at GANG_SHAPE, causal, on inputs seeded by its rank, holds the
    output to the plain version under the bf16 limits, and all-reduces its
    relative error (MAX) and its output's checksum (SUM) over the group."""
    import torch.distributed as dist

    _, _, _, fa, _, _ = enforce_port()
    from k8s_vgpu_scheduler_tpu_torch.parallel import multihost

    t0 = time.monotonic()
    check(multihost.initialize_from_env("gloo", timeout_s=GANG_TIMEOUT_S),
          "no gang env in the member's Allocate answer")
    joined = time.monotonic()
    rank, size = dist.get_rank(), dist.get_world_size()
    check(rank == int(os.environ["VTPU_GANG_RANK"]),
          f"rank {rank} is not VTPU_GANG_RANK")
    B, T, H, d = GANG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19 + rank)
    q, k, v = (torch.randn(B, T, H, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    fa.flash_attention.launches = 0
    got = fa.flash_attention(q, k, v, causal=True)
    launches = fa.flash_attention.launches
    want = fa._reference(q, k, v, d ** -0.5, True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), "the output is not finite")
    row = grad_errors(torch, got, want, False)
    row.update(tol_rel_max=2 ** -7 + 2 ** -8 * v.float().abs().max().item()
               / row["max_abs_want"], tol_rel_rms=TOL_O_BF16_RMS,
               tol_tile_rel_rms=TOL_O_BF16_TILE)
    check(row["rel_max_err"] <= row["tol_rel_max"]
          and row["rel_rms_err"] <= TOL_O_BF16_RMS
          and row["tile_rel_rms_err"] <= TOL_O_BF16_TILE,
          f"rank {rank}: the kernel disagrees with its plain version {row}")
    checksum = got.double().sum().item()
    err = torch.tensor([row["rel_max_err"]], dtype=torch.float64)
    total = torch.tensor([checksum], dtype=torch.float64)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    reduced = time.monotonic()
    dist.destroy_process_group()
    return dict(rank=rank, size=size, launches=launches, errors=row,
                checksum=checksum, max_rel_err_all=err.item(),
                checksum_all=total.item(), rendezvous_s=joined - t0,
                joined_t=joined, reduced_t=reduced,
                peak_allocated=torch.cuda.max_memory_allocated(),
                interposer=interposer_stats(), grant_env=grant_env())


def workload_build(torch, name: str, refs: Path, bare: bool) -> tuple:
    """One case of models/workloads.py on the card, built from
    WORKLOAD_SEED, and the f32 path of its weights: its logits (in
    training, the loss before any step).  The bare leg computes it and
    keeps it in ``refs`` for the pods, then empties the cache of what it
    took; a pod reads it."""
    from k8s_vgpu_scheduler_tpu_torch.models import workloads as wl

    torch.backends.cudnn.benchmark = False
    w = wl.build(name, torch.Generator(device="cuda").manual_seed(
        WORKLOAD_SEED))
    if not bare:
        return w, torch.load(refs / f"{name}.pt")
    with torch.no_grad():
        ref = (wl.loss(w, torch.float32) if w.case.train
               else wl.infer_step(w, torch.float32)).cpu()
    gc.collect()
    torch.cuda.empty_cache()
    return w, {"f32": ref}


def workload_measure(torch, name: str, w, ref: dict) -> dict:
    """The case's bf16 output (in training, step 0's loss) against the
    f32 path, then WORKLOAD_WINDOWS windows of ``timed`` (2 warm-ups,
    ``iters`` steps by CUDA events each): the median window's images/s,
    and the first window's losses, which must be finite."""
    from k8s_vgpu_scheduler_tpu_torch.models import workloads as wl

    torch.cuda.reset_peak_memory_stats()
    out = (wl.train_step(w) if w.case.train else wl.infer_step(w)).cpu()
    diff = float((out.double() - ref["f32"].double()).norm()
                 / ref["f32"].double().norm())
    windows = [wl.timed(w) for _ in range(WORKLOAD_WINDOWS)]
    torch.cuda.synchronize()
    t = sorted(windows, key=lambda r: r["seconds"])[WORKLOAD_WINDOWS // 2]
    losses = windows[0]["losses"]  # bench.py's iters steps from step 1
    check(losses is None or all(math.isfinite(v) for v in losses),
          f"{name}: losses {losses}")
    check(diff <= TOL_WORKLOAD[name], f"{name}: bf16 against the f32 path "
          f"{diff:.3e}, limit {TOL_WORKLOAD[name]}")
    return dict(case=name, bf16_vs_f32=diff, out=out,
                same_as_bare=torch.equal(out, ref["bf16"])
                if "bf16" in ref else None,
                seconds=t["seconds"], images_per_s=t["images_per_s"],
                windows=[r["images_per_s"] for r in windows], losses=losses,
                reserved_peak=torch.cuda.max_memory_reserved(),
                allocated_peak=torch.cuda.max_memory_allocated())


def child_workloads_bare(torch):
    """The bare leg of phase_workloads: no interposer, the ten cases in
    turn, the cache emptied between them; each case's f32 path and bf16
    output kept for the pods, its FLOPs (one more step, counted), and a
    traced step of WORKLOAD_PROFILED after them all.  Prints WORKLOAD_CASE
    lines around each case's bf16 steps, by which the parent reads
    nvidia-smi's peak."""
    from k8s_vgpu_scheduler_tpu_torch.models import workloads as wl

    refs = Path(os.environ["WORKLOAD_REFS"])
    baseline = smi_card_mib()
    cases = {}
    for name in wl.CASES:
        t0 = time.monotonic()
        w, ref = workload_build(torch, name, refs, bare=True)
        log(f"WORKLOAD_CASE begin {name}")
        row = workload_measure(torch, name, w, ref)
        row["smi_mib"] = smi_card_mib() - baseline  # its memory still held
        log(f"WORKLOAD_CASE end {name}")
        torch.save({"f32": ref["f32"], "bf16": row.pop("out")},
                   refs / f"{name}.pt")
        row["flops_per_step"] = wl.step_flops(w)
        del w
        gc.collect()
        torch.cuda.empty_cache()
        row["run_s"] = time.monotonic() - t0
        cases[name] = row
    # Traced last: a process CUPTI has traced may pay for it in every
    # later launch, which the host-bound cases' images/s would carry.
    for name in WORKLOAD_PROFILED:
        w, _ = workload_build(torch, name, refs, bare=False)
        step = wl.train_step if w.case.train else wl.infer_step
        step(w)
        cases[name]["profile"] = device_profile(
            torch, lambda: step(w), top=8, groups=WORKLOAD_GROUPS)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    return dict(cases=cases)


def child_workload_pod(torch, name: str):
    """One pod of phase_workloads: the case through the preloaded
    interposer under its grant (no compute limit).  Once it has run, with
    its memory held: nvidia-smi's reading (less the card's before this
    process brought CUDA up), the region's ``used`` and the interposer's
    counters."""
    import ctypes

    baseline = smi_card_mib()
    w, ref = workload_build(torch, name, Path(os.environ["WORKLOAD_REFS"]),
                            bare=False)
    built = interposer_stats()["launches"]
    row = workload_measure(torch, name, w, ref)
    del row["out"]
    row["launches_per_step"] = ((interposer_stats()["launches"] - built)
                                / (1 + WORKLOAD_WINDOWS * (w.case.iters + 2)))
    get_used = ctypes.CDLL(None).vgpu_get_used
    get_used.argtypes, get_used.restype = [ctypes.c_int], ctypes.c_uint64
    row.update(smi_mib=smi_card_mib() - baseline, region_used=get_used(0),
               smi_baseline_mib=baseline, interposer=interposer_stats())
    del w
    return row


ENFORCE_CHILDREN = {"memory_cap": child_memory_cap,
                    "load_oom": child_load_oom,
                    "train": child_train,
                    "interposer_cap": child_interposer_cap,
                    "interposer_pod": child_interposer_pod,
                    "plain_torch": child_plain_torch,
                    "oci_pod": child_oci_pod,
                    "cotenant": child_cotenant,
                    "interposer_train": child_interposer_train,
                    "interposer_swap": child_interposer_swap,
                    "preempt_swap": child_preempt_swap,
                    "cores_train": child_cores_train,
                    "cores_serve": child_cores_serve,
                    "preempt": child_preempt,
                    "quota_pod": child_quota_pod,
                    "gang_member": child_gang_member,
                    "workloads_bare": child_workloads_bare}


def enforce_child(name: str) -> int:
    """One sub-phase of phase_enforce, in a process of its own: imports
    what it needs, waits for the parent's go on stdin (the card is then
    this sub-phase's), and prints its readings as one ENFORCE line."""
    import torch

    if name not in ("plain_torch", "cotenant", "oci_pod"):  # torch alone
        enforce_port()
    print("READY", flush=True)
    if sys.stdin.readline() != "go\n":
        return 3  # the parent is gone: leave the card alone
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    try:
        if name.startswith("workload:"):
            out = child_workload_pod(torch, name.split(":", 1)[1])
        else:
            out = ENFORCE_CHILDREN[name](torch)
    except Fail as exc:
        print(f"chip_smoke: FAIL: {name}: {exc}", file=sys.stderr)
        return 1
    out["run_s"] = time.monotonic() - t0
    print("ENFORCE " + json.dumps(out), flush=True)
    if name.startswith("cores_"):
        # Leave the region's slot behind, as a killed process does: the
        # node monitor's GC must clear it.
        sys.stderr.flush()
        os._exit(0)
    return 0


class EnforceChild:
    """One sub-phase under ``grant`` (env) with a region of its own, in a
    process started at once: its start-up (the Python imports) overlaps
    the sub-phases before it, and it touches the card only after
    :meth:`run`.  Its output goes to chiprun_out/enforce_<label>.log."""

    def __init__(self, name, tmp: Path, label=None, region=None,
                 **grant) -> None:
        self.label = label or name
        self.started = time.monotonic()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(GRANT_ENV)}
        env.update({k: str(v) for k, v in grant.items()})
        env["CUDA_DEVICE_MEMORY_SHARED_CACHE"] = str(
            region or tmp / self.label / "cudevshr.cache")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--enforce-child",
             name], env=env, cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def run(self, record, section: str = "enforce",
            on_line=lambda line: None) -> dict:
        """Let it go on the card and wait for its readings, kept in
        ``record[section]`` under its label.  ``on_line`` is called with
        each line of its stdout as it comes."""
        t0 = time.monotonic()
        err, late = [], []
        drain = threading.Thread(target=lambda: err.append(
            self.proc.stderr.read()), daemon=True)
        timer = threading.Timer(300, lambda: (late.append(True),
                                              self.proc.kill()))
        drain.start()
        timer.start()
        try:
            try:
                self.proc.stdin.write("go\n")
                self.proc.stdin.close()
            except BrokenPipeError:  # it has already exited: read why
                pass
            lines = []
            for line in self.proc.stdout:
                lines.append(line)
                on_line(line.rstrip("\n"))
            self.proc.wait()
            drain.join()
        finally:
            timer.cancel()
        check(not late, f"enforce child {self.label} ran past 300 s")
        stdout, stderr = "".join(lines), "".join(err)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"enforce_{self.label}.log").write_text(stdout + stderr)
        check(self.proc.returncode == 0, f"enforce child {self.label} exited "
              f"{self.proc.returncode}: {stderr.strip()[-2000:]}")
        line = [x for x in stdout.splitlines() if x.startswith("ENFORCE ")]
        check(len(line) == 1, f"enforce child {self.label} printed no result")
        reading = json.loads(line[0][len("ENFORCE "):])
        reading["child_s"] = time.monotonic() - t0
        reading["life_s"] = time.monotonic() - self.started
        reading["pid"] = self.proc.pid
        record.setdefault(section, {})[self.label] = reading
        return reading

    def wait_ready(self) -> None:
        """Wait until it has imported what it needs (its READY line)."""
        line = self.proc.stdout.readline()
        check(line == "READY\n", f"enforce child {self.label} did not start: "
              f"{line!r}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def phase_enforce(torch, record, interposer: Path, driver: Path):
    """The enforcement layer on the card, each sub-phase in a child process
    with its own grant and region: the inventory and a 24000 MiB memory
    cap under the 32-layer forward (alone on the card, which it measures);
    the 8-layer train step uncapped with an oversubscribed grant (its
    AdamW state through host swap after the warm-up); then under a 30%
    compute grant, beside an 8000 MiB grant the weights cannot fit (a
    child that runs no kernel, at the capped step's idle 70%).  Then the
    interposer (``interposer``, preloaded), each alone on the card: the
    24000 MiB cap with the context counted, two processes of one pod on
    one 24000 MiB grant (their contexts made together while a co-tenant
    outside the pod allocates and frees), a process that imports only
    torch under 8000 MiB, the train step without the interposer and
    through it uncapped, AB_PAIRS times in turn, through it at 30%
    with the Python gate off, and through it with an oversubscribed
    40000 MiB grant, its AdamW state through host swap at the spill-only
    gate (child_interposer_swap).  Returns the port kernels' launches in
    the children (each child counts from 0)."""
    uuid = nvidia_smi("uuid")
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(0)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(3) as pool:
        tmp = Path(tmp)
        pod = tmp / "pod"
        pod.mkdir()
        preload = dict(LD_PRELOAD=interposer, NVIDIA_VISIBLE_DEVICES=uuid)
        cap = f"{ENFORCE_LIMIT_MIB}m"
        children = [
            EnforceChild("memory_cap", tmp,
                         CUDA_DEVICE_MEMORY_LIMIT_0=cap,
                         NVIDIA_VISIBLE_DEVICES=uuid,
                         PARENT_USED=total - free),
            EnforceChild("train", tmp, label="uncapped", VTPU_SYNC_EVERY=1,
                         CUDA_OVERSUBSCRIBE="true"),
            EnforceChild("load_oom", tmp,
                         CUDA_DEVICE_MEMORY_LIMIT_0=(
                             f"{ENFORCE_SMALL_LIMIT_MIB}m"),
                         NVIDIA_VISIBLE_DEVICES=uuid),
            EnforceChild("train", tmp, label="capped", VTPU_SYNC_EVERY=1,
                         CUDA_DEVICE_SM_LIMIT=ENFORCE_SM_LIMIT,
                         GPU_CORE_UTILIZATION_POLICY="force"),
            EnforceChild("interposer_cap", tmp,
                         CUDA_DEVICE_MEMORY_LIMIT_0=cap, **preload),
            *(EnforceChild("interposer_pod", tmp, label=f"pod{i}",
                           region=pod / "cudevshr.cache",
                           CUDA_DEVICE_MEMORY_LIMIT_0=cap, POD_DIR=pod,
                           POD_INDEX=i, **preload) for i in range(2)),
            EnforceChild("cotenant", tmp, POD_DIR=pod),
            EnforceChild("plain_torch", tmp,
                         CUDA_DEVICE_MEMORY_LIMIT_0=(
                             f"{ENFORCE_SMALL_LIMIT_MIB}m"), **preload)]
        for i in range(AB_PAIRS):  # without and with the interposer, in turn
            children += [
                EnforceChild("interposer_train", tmp,
                             label=f"train_plain_{i}"),
                EnforceChild("interposer_train", tmp,
                             label=f"interposer_uncapped_{i}", **preload)]
        children.append(EnforceChild(
            "interposer_train", tmp, label="interposer_capped",
            CUDA_DEVICE_SM_LIMIT=ENFORCE_SM_LIMIT,
            GPU_CORE_UTILIZATION_POLICY="force", **preload))
        children.append(EnforceChild(
            "interposer_swap", tmp, CUDA_OVERSUBSCRIBE="true",
            CUDA_DEVICE_MEMORY_LIMIT_0=f"{CORES_TRAIN_MIB}m", **preload))
        try:
            mem = children[0].run(record)
            uncapped = children[1].run(record)
            load_oom = pool.submit(children[2].run, record)
            capped = children[3].run(record)
            load_oom.result()
            icap = children[4].run(record)
            pods, pod_smi, cotenant = run_pod(pool, pod, children[5:7],
                                              children[7], record)
            plain_torch = children[8].run(record)
            trains = {c.label: c.run(record) for c in children[9:-1]}
            iswap = children[-1].run(record)
            costs = {"uncapped": launch_cost(driver, interposer, tmp,
                                             "launch_uncapped"),
                     "capped": launch_cost(
                         driver, interposer, tmp, "launch_capped",
                         CUDA_DEVICE_SM_LIMIT=ENFORCE_SM_LIMIT,
                         GPU_CORE_UTILIZATION_POLICY="force")}
        finally:
            (pod / "release").touch()
            for child in children:
                child.stop()
    record["enforce_s"] = time.monotonic() - t0
    swap = uncapped["host_swap"]
    check(capped["sm_limit"] == ENFORCE_SM_LIMIT
          and uncapped["sm_limit"] == 0, "the region's SM limits")
    check(abs(capped["duty"] - ENFORCE_SM_LIMIT / 100) <= TOL_DUTY_POINTS,
          f"capped duty {capped['duty']:.4f}, grant {ENFORCE_SM_LIMIT}%")
    check(uncapped["duty"] > MIN_UNCAPPED_DUTY,
          f"uncapped duty {uncapped['duty']:.4f}")
    check(swap is not None and capped["host_swap"] is None,
          "host swap ran in the wrong child")
    # The capped run never suspends: equal losses show both that
    # throttling and that the swap leave the results as they were.
    check(capped["losses"] == uncapped["losses"],
          f"capped losses {capped['losses']} != uncapped (swapped after "
          f"step 2) {uncapped['losses']}")
    interposed = interposer_checks(icap, pods, pod_smi, cotenant,
                                   plain_torch, trains, capped["losses"])
    unswapped = trains["interposer_uncapped_0"]["losses"]
    check(iswap["losses"] == unswapped[:len(iswap["losses"])],
          f"losses after the swap under the interposer {iswap['losses']} "
          f"!= the unswapped interposed run's {unswapped}")
    interposed["host_swap"] = {k: iswap[k] for k in (
        "freed", "limiter_calls", "pressure")} | {
        k: iswap["host_swap"][k] for k in ("state_bytes", "suspend_s",
                                           "resume_s", "resumed_bitwise")}
    interposed["host_us_per_launch"]["null_kernel"] = costs
    summary = {
        "phase": "enforce", "card": record["card"],
        "seconds": record["enforce_s"],
        "inventory": mem["inventory"]["torch"],
        "mock_h100": mem["inventory"]["mock"],
        "memory_cap": {k: mem[k] for k in (
            "limit", "fraction", "memory_info_total", "flash_launches",
            "profile_flash_fwd_mma_calls", "reserved_at_refusal",
            "grant_minus_reserved_at_refusal", "region_used",
            "reserved_when_read", "outside_allocator_bytes")},
        "load_oom": {k: record["enforce"]["load_oom"][k]
                     for k in ("limit", "reserved_at_refusal",
                               "load_until_refused_s")},
        "child_s": {label: run["child_s"]
                    for label, run in record["enforce"].items()},
        "compute": {name: {k: run[k] for k in (
            "sm_limit", "duty", "median_step_s", "device_ms", "charged_us",
            "losses")} for name, run in (("uncapped", uncapped),
                                         ("capped", capped))},
        "host_swap": {k: swap[k] for k in (
            "state_bytes", "freed", "suspend_s", "resume_s",
            "resumed_bitwise")},
        "interposer": interposed,
    }
    log(f"memory cap: {mem['outside_allocator_bytes'] / MIB:.0f} MiB of the "
        "capped child on the card outside the caching allocator (its CUDA "
        "context: driver state, kernel images, library handles), not "
        "counted against the grant; a first product allocated "
        f"{mem['inventory']['first_product_workspace_bytes']}"
        " bytes beyond its output through the allocator (cuBLAS's "
        "workspace, counted)")
    log(f"interposer: refusal at {icap['smi_used_mib_at_refusal']} MiB by "
        f"nvidia-smi under a {ENFORCE_LIMIT_MIB} MiB grant, context "
        f"{icap['context_bytes']} bytes charged, {icap['footprint_bytes']} "
        f"on the card; pod peak {interposed['pod']['smi_peak_mib']} MiB "
        f"beside a co-tenant's {cotenant['cycles']} allocations; capped duty "
        f"{trains['interposer_capped']['duty']:.4f}")
    log(json.dumps(summary))
    counts = [sum(run["launches"][n] for run in (uncapped, capped, iswap,
                                                 *trains.values()))
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    counts[0] += mem["flash_launches"] + icap["flash_launches"]
    return counts


def launch_cost(driver: Path, interposer: Path, tmp: Path, label: str,
                **grant) -> dict:
    """The interposer's host time a launch: its C test driver launches a
    null kernel NULL_LAUNCHES times through the hooks and as many straight
    to the driver, in one process (the least of 5 rounds each)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(GRANT_ENV)}
    env.update({k: str(v) for k, v in grant.items()},
               LD_PRELOAD=str(interposer),
               CUDA_DEVICE_MEMORY_SHARED_CACHE=str(tmp / label / "c.cache"))
    res = subprocess.run([str(driver), "launch_cost", str(NULL_LAUNCHES)],
                         env=env, capture_output=True, text=True, timeout=120)
    check(res.returncode == 0 and "RESULT PASS" in res.stdout,
          f"launch_cost {label}: {res.stdout[-1000:]} {res.stderr[-1000:]}")
    line = next(x for x in res.stdout.splitlines()
                if x.startswith("LAUNCH_NS "))
    hooked, direct = float(line.split()[2]), float(line.split()[4])
    return {"hooked_ns": hooked, "direct_ns": direct,
            "added_us": (hooked - direct) / 1e3}


def run_pod(pool, pod: Path, pods, cotenant, record):
    """The pod's two processes bring CUDA up together while ``cotenant``
    churns; once it has ended, they take blocks while the card is watched.
    Returns their readings, nvidia-smi's and the co-tenant's."""
    baseline = smi_card_mib()  # before any of them brings CUDA up
    churn = pool.submit(cotenant.run, record)
    runs = [pool.submit(c.run, record) for c in pods]
    t0 = time.monotonic()
    while not all((pod / f"ready{i}").exists() for i in range(2)):
        check(time.monotonic() - t0 < 120 and not churn.done()
              and not any(f.done() for f in runs),
              "the pod's contexts did not come up beside the co-tenant")
        time.sleep(0.01)
    (pod / "stop_cotenant").touch()
    churned = churn.result()
    (pod / "blocks").touch()
    readings = watch_pod(pod, pods, baseline)
    return [f.result() for f in runs], readings, churned


def watch_pod(pod: Path, children, baseline: int) -> list:
    """nvidia-smi's reading of the pod (the card's used memory less
    ``baseline``, what it held before the pod's processes started) while
    its two processes take blocks, until both are refused or gone (the
    last reading has both holding what they took); then lets them go."""
    readings = []
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 240:
            done = all((pod / f"refused{i}").exists() for i in range(2))
            gone = any(c.proc.poll() is not None for c in children)
            readings.append(smi_card_mib() - baseline)
            if done or gone:
                break
    finally:
        (pod / "release").touch()
    return readings


def interposer_checks(icap, pods, pod_smi, cotenant, plain_torch, trains,
                      gated_losses) -> dict:
    """The checks across the interposer's children, and their summary."""
    plains = [trains[f"train_plain_{i}"] for i in range(AB_PAIRS)]
    frees = [trains[f"interposer_uncapped_{i}"] for i in range(AB_PAIRS)]
    capped = trains["interposer_capped"]
    check(bool(pod_smi), "no nvidia-smi reading of the pod")
    check_grant(pod_smi[-1], ENFORCE_LIMIT_MIB, "the pod's two processes")
    check(max(pod_smi) <= ENFORCE_LIMIT_MIB,
          f"the pod's two processes read {pod_smi} MiB by nvidia-smi, grant "
          f"{ENFORCE_LIMIT_MIB} MiB")
    rate = cotenant["cycles"] / max(cotenant["last_s"] - cotenant["first_s"],
                                    1e-9)
    for p in pods:
        start, end = p["ctx_window_s"]
        check(cotenant["first_s"] <= start and end <= cotenant["last_s"]
              and rate * (end - start) >= 10,
              f"the co-tenant ({cotenant}) did not churn all through a pod "
              f"context's bring-up ({start}, {end})")
        check(p["interposer"]["context_bytes"]
              == icap["interposer"]["context_bytes"],
              f"a pod context charged {p['interposer']['context_bytes']} "
              "bytes beside the co-tenant")
    check(capped["sm_limit"] == str(ENFORCE_SM_LIMIT)
          and all(f["sm_limit"] is None for f in frees),
          "the interposer children's grants")
    check(abs(capped["duty"] - ENFORCE_SM_LIMIT / 100) <= TOL_DUTY_POINTS,
          f"interposer capped duty {capped['duty']:.4f}, grant "
          f"{ENFORCE_SM_LIMIT}%")
    for run in (*plains, *frees):  # uncapped: the Python gate's bound too
        check(run["duty"] > MIN_UNCAPPED_DUTY,
              f"uncapped duty {run['duty']:.4f} (preloaded: "
              f"{run['preloaded']})")
    # Uncapped, the interposer must gate no launch.
    for free in frees:
        check(free["interposer"]["gated"] == 0
              and free["interposer"]["charged_us"] == 0,
              f"the uncapped interposer gated launches: {free['interposer']}")
    losses = [run["losses"] for run in (*plains, *frees, capped)]
    check(all(x == losses[0] for x in losses)
          and capped["losses"][:len(gated_losses)] == gated_losses,
          f"losses differ: {losses}, gated {gated_losses}")
    launches = frees[0]["hooked_launches_per_step"]
    # Each pair's step wall with the interposer less without it, a launch.
    added = [(b["median_step_s"] - a["median_step_s"]) * 1e6 / launches
             for a, b in zip(plains, frees)]
    mean = statistics.mean(added)
    spread = max(added) - min(added)
    return {
        "cap": {k: icap[k] for k in (
            "limit", "mem_get_info_total", "device_total_memory",
            "flash_launches", "blocks_before_refusal",
            "smi_used_mib_at_refusal", "grant_minus_smi_mib",
            "region_used_at_refusal", "reserved_at_refusal",
            "context_bytes", "context_bytes_at_init", "footprint_bytes",
            "refusals")},
        "pod": {"blocks": [p["blocks"] for p in pods],
                "smi_mib": pod_smi, "smi_peak_mib": max(pod_smi),
                "context_bytes": [p["interposer"]["context_bytes"]
                                  for p in pods],
                "ctx_window_s": [p["ctx_window_s"] for p in pods],
                "cotenant": cotenant},
        "plain_torch": {k: plain_torch[k] for k in (
            "limit", "mem_get_info_total", "blocks_before_refusal",
            "smi_used_mib_at_refusal", "port_modules")},
        "train": {name: {k: run.get(k) for k in (
            "duty", "median_step_s", "busy_ms_per_step",
            "hooked_launches_per_step", "charged_us_per_step",
            "charged_over_busy", "losses")}
            for name, run in trains.items()},
        "host_us_per_launch": {
            "train_step_pairs": added, "train_step_mean": mean,
            "train_step_spread": spread,
            "train_step_resolved": abs(mean) > spread},
    }


# A timeline sample's fields (Timeline).
T_, SWITCH, RECENT, WEIGHT, YIELD, PIDS, USED = range(7)


class Timeline:
    """Every TIMELINE_S, each region under ``root`` through the port's
    RegionReader (its own handles, beside the monitor's): the time, the
    switch, recent_kernel, the QoS weight and yield, the pids of the proc
    slots and device 0's used bytes, by container key."""

    def __init__(self, reader, root: Path) -> None:
        self.reader, self.root = reader, root
        self.samples: dict = {}
        self._regions: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from k8s_vgpu_scheduler_tpu_torch.monitor import scan_container_dirs

        while not self._stop.is_set():
            t = time.monotonic()
            for key, path in scan_container_dirs(str(self.root)).items():
                r = self._regions.get(key) or self.reader.open(path)
                if r is None:
                    continue  # not initialized yet
                self._regions[key] = r
                self.samples.setdefault(key, []).append((
                    t, r.utilization_switch, r.recent_kernel, r.qos_weight,
                    r.qos_yield, tuple(r.proc_pids()), r.used(0)))
            self._stop.wait(TIMELINE_S)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        for r in self._regions.values():
            r.close()

    def of(self, key: str, lo: float = 0.0, hi: float = math.inf) -> list:
        return [x for x in list(self.samples.get(key, ()))
                if lo <= x[T_] <= hi]

    def first(self, key: str, since: float, field: int, value) -> float:
        """The time of the first sample at or after ``since`` whose
        ``field`` reads ``value``, or inf."""
        return next((x[T_] for x in self.of(key, since)
                     if x[field] == value), math.inf)

    def on_seconds(self, key: str) -> float:
        """The switch's summed on-time, sample to sample."""
        xs = self.of(key)
        return sum(b[T_] - a[T_] for a, b in zip(xs, xs[1:]) if a[SWITCH])


def await_file(path: Path, futures, what: str, limit: float = 300) -> None:
    """Wait for a child's handshake file; fail at once if a child ended
    (raising its failure) or after ``limit`` seconds."""
    t0 = time.monotonic()
    while not path.exists():
        for f in futures:
            if f.done():
                f.result()
                check(False, f"{what}: a pod ended first")
        check(time.monotonic() - t0 < limit, f"no {what} in {limit} s")
        time.sleep(0.01)


def await_switch(tl: Timeline, key: str, value: int, since: float,
                 what: str, limit: float = 60) -> float:
    t0 = time.monotonic()
    while math.isinf(t := tl.first(key, since, SWITCH, value)):
        check(time.monotonic() - t0 < limit, f"{what}: no switch {value} "
              f"in {limit} s")
        time.sleep(TIMELINE_S)
    return t


def await_gc(tl: Timeline, keys, what: str) -> None:
    """Wait until the monitor's GC has cleared every slot of ``keys``
    (pods that exited without detaching) and their used bytes."""
    t0 = time.monotonic()
    while True:
        last = [tl.of(k)[-1] for k in keys]
        if all(not x[PIDS] and x[USED] == 0 for x in last):
            return
        check(time.monotonic() - t0 < 10 * MONITOR_INTERVAL_S,
              f"{what}: the monitor left the exited pods' slots {last}")
        time.sleep(TIMELINE_S)


def duty_over(steps: list, pieces, step_ms: float) -> dict:
    """T's duty over the time ``pieces`` ([a, b] each), from the untraced
    steps that lie wholly inside one: on the solo basis (steps x
    ``step_ms``, T's device time a step alone) and on the interposer's
    charge (its charged µs across them), each over their wall."""
    n, wall, charged = 0, 0.0, 0
    for a, b in pieces:
        idx = [i for i, s in enumerate(steps) if i and not s["traced"]
               and a <= s["start"] and s["end"] <= b]
        if not idx:
            continue
        run = steps[idx[0]:idx[-1] + 1]
        n += len(run)
        wall += run[-1]["end"] - run[0]["start"]
        charged += run[-1]["charged_us"] - steps[idx[0] - 1]["charged_us"]
    check(n > 0 and wall > 0, f"no train step inside {pieces}")
    return dict(steps=n, wall_s=wall, solo=n * step_ms / (wall * 1e3),
                charge=charged / 1e6 / wall)


def cut(window, span):
    """``window`` less ``span``: one or two pieces."""
    a, b = window
    lo, hi = span
    if hi <= a or lo >= b:
        return [window]
    return [p for p in ((a, lo), (hi, b)) if p[1] > p[0]]


def serve_summary(run: dict) -> dict:
    """TTFT and decode rate over every measured wave of an S run."""
    waves = [w for b in run["bursts"] for w in b["waves"]]
    ttft = [t for w in waves for t in w["ttft_s"]]
    tokens = sum(w["decode_tokens"] for w in waves)
    return dict(waves=len(waves), ttft_p50_s=statistics.median(ttft),
                ttft_max_s=max(ttft),
                decode_tokens_per_s=tokens / sum(w["decode_s"]
                                                 for w in waves),
                wave_s=statistics.median(w["end"] - w["start"]
                                         for w in waves),
                init_s=run["init_s"])


def phase_coresidency(torch, record, vgpu: Path, interposer: Path):
    """Two pods share the card under the port's node monitor, with no
    ``force`` anywhere.  The monitor (cmd/monitor.py's loop: FeedbackLoop
    then UsageSampler) runs in a thread of this process every 0.5 s over
    ``<tmp>/containers/``; each pod is a child with its region there, the
    interposer preloaded and the card's UUID in NVIDIA_VISIBLE_DEVICES.
    S serves the 32-layer llama_7b (priority 0, 50% of the card, 24000
    MiB), T trains the 8-layer step (priority 1, 50%, 40000 MiB).  First S
    alone, without and with the interposer; then the flat leg: T alone,
    then S's two bursts of waves with an idle gap, T stepping throughout;
    then the tiered leg: S latency-critical, T best-effort, under the
    QosConfig defaults.  Checks F1–F7 (coresidency_checks) and returns the
    port kernels' launches in the pods."""
    from k8s_vgpu_scheduler_tpu_torch.accounting import UsageSampler
    from k8s_vgpu_scheduler_tpu_torch.cmd import monitor
    from k8s_vgpu_scheduler_tpu_torch.monitor import FeedbackLoop, RegionReader

    uuid = nvidia_smi("uuid")
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    runs = record.setdefault("coresidency_children", {})
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        tmp = Path(tmp)
        root = tmp / "containers"
        root.mkdir()

        def pod(name, key, leg, **grant):
            (tmp / leg).mkdir(exist_ok=True)
            child = EnforceChild(name, tmp, label=key,
                                 region=root / key / "cudevshr.cache",
                                 CORES_DIR=tmp / leg,
                                 NVIDIA_VISIBLE_DEVICES=uuid,
                                 CUDA_DEVICE_SM_LIMIT=CORES_SM_LIMIT, **grant)
            child.ctl = tmp / leg
            child.name = grant.get("CORES_NAME")
            child.go = lambda: pool.submit(child.run, record,
                                           "coresidency_children")
            return child

        serve = dict(CUDA_TASK_PRIORITY=0,
                     CUDA_DEVICE_MEMORY_LIMIT_0=f"{CORES_SERVE_MIB}m")
        train = dict(CUDA_TASK_PRIORITY=1, LD_PRELOAD=interposer,
                     CUDA_DEVICE_MEMORY_LIMIT_0=f"{CORES_TRAIN_MIB}m")
        # Started at once: their imports overlap; each touches the card
        # only after its go.
        children = [
            *(pod("cores_serve", key, "alone", CORES_NAME=key,
                  CORES_BURSTS=CORES_ALONE_S, **serve,
                  **(dict(LD_PRELOAD=interposer) if i % 2 else {}))
              for i, key in enumerate(ALONE)),
            pod("cores_train", "uidF_train", "flat", **train),
            pod("cores_serve", "uidF_serve", "flat", CORES_NAME="serve",
                CORES_BURSTS=f"{CORES_BURST_S},{CORES_BURST_S}",
                LD_PRELOAD=interposer, **serve),
            pod("cores_train", "uidQ_train", "tiered",
                VTPU_QOS_CLASS="best-effort", **train),
            pod("cores_serve", "uidQ_serve", "tiered", CORES_NAME="serve",
                CORES_BURSTS=CORES_TIERED_S, LD_PRELOAD=interposer,
                VTPU_QOS_CLASS="latency-critical", **serve)]
        reader = RegionReader(str(vgpu))
        loop = FeedbackLoop(str(root), reader=reader)
        sampler = UsageSampler(loop)
        stop = threading.Event()
        # The monitor's own view after each tick: every region's slots,
        # and the critical class's dispatch-wait p99 on each GPU.
        ticks = record.setdefault("coresidency_monitor", [])
        ticker = threading.Thread(target=monitor.run, daemon=True, args=(
            loop, sampler, MONITOR_INTERVAL_S, stop), kwargs=dict(
                on_tick=lambda: ticks.append((time.monotonic(), {
                    k: c.region.proc_pids()
                    for k, c in loop.containers.items()},
                    dict(loop.qos.critical_p99_us)))))
        ticker.start()
        tl = Timeline(reader, root)
        try:
            legs = {}
            for s in children[:len(ALONE)]:  # S alone on the card
                fut = s.go()
                await_file(s.ctl / f"{s.name}_ready", [fut],
                           f"{s.label} ready")
                (s.ctl / f"{s.name}_go").touch()
                legs[s.label] = fut.result()
            legs.update(flat_leg(tl, *children[-4:-2]))
            legs.update(tiered_leg(tl, *children[-2:]))
            with loop.lock:
                qos = dict(critical_p99_us=dict(loop.qos.critical_p99_us),
                           reweights_total=loop.qos.reweights_total)
            rows = {r["ctrkey"]: r for r in sampler.snapshot()}
        finally:
            stop.set()
            ticker.join()
            tl.close()
            loop.close()
            for child in children:
                child.stop()
            record["coresidency_timeline"] = tl.samples
    record["coresidency_s"] = time.monotonic() - t_phase
    record["coresidency_region_scan"] = region_scan_cost()
    log("the monitor's region-scan ticks:",
        json.dumps(record["coresidency_region_scan"]))
    summary = record["coresidency"] = coresidency_checks(
        record, tl, legs, rows, qos, ticks)
    log(json.dumps(summary))
    return [sum(run["launches"].get(n, 0) for run in legs.values()
                if isinstance(run, dict) and "launches" in run)
            for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]


def region_scan_cost(n: int = 20000) -> dict:
    """What the ``region-scan`` span costs each monitor tick, beside the
    tick itself: the process's histogram of the ticks so far (count, mean
    seconds) and the mean of ``n`` spans around nothing, with the tick's
    one attribute, in a tracer of their own (the process's histogram stays
    as the ticks left it).  The span opens before the feedback loop's tick
    and closes after the sampler's, so it holds no region's lock."""
    from k8s_vgpu_scheduler_tpu_torch.util import trace

    snap = trace.tracer().histogram_snapshot().get(("region-scan", ""))
    check(snap is not None and snap[1] > 0, "no region-scan tick recorded")
    tr = trace.Tracer()
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("region-scan") as sp:
            sp.set("containers", 0)
    span_s = (time.perf_counter() - t0) / n
    return dict(ticks=snap[1], mean_tick_s=snap[2] / snap[1], span_s=span_s,
                span_share_of_interval=span_s / MONITOR_INTERVAL_S)


def flat_leg(tl: Timeline, t, s) -> dict:
    """T alone (F1's window, then 3 traced steps for its device time a
    step); S loads and warms up; once T's switch has fallen, S's two
    bursts (T's second traced window 3 s into the second); T alone again
    for CORES_TAIL_S; both exit, and the monitor must clear their slots."""
    ft = t.go()
    await_file(t.ctl / "train_ready", [ft], "T ready")
    solo = [time.monotonic()]
    time.sleep(CORES_SOLO_S)
    solo.append(time.monotonic())
    (t.ctl / "trace_solo").touch()
    await_file(t.ctl / "traced_solo", [ft], "T's solo trace")
    fs = s.go()
    await_file(s.ctl / f"{s.name}_ready", [ft, fs], "S ready", limit=600)
    await_switch(tl, t.label, 0, time.monotonic(), "T after S's loading")
    time.sleep(MONITOR_INTERVAL_S)
    (s.ctl / f"{s.name}_go").touch()
    await_file(s.ctl / f"{s.name}_burst1", [ft, fs], "S's second burst")
    time.sleep(3.0)
    (t.ctl / "trace_shared").touch()
    await_file(t.ctl / "traced_shared", [ft, fs], "T's shared trace")
    serve = fs.result()
    time.sleep(CORES_TAIL_S)
    (t.ctl / "train_stop").touch()
    trainer = ft.result()
    await_gc(tl, (t.label, s.label), "flat leg")
    return {t.label: trainer, s.label: serve, "flat": dict(solo=solo)}


def tiered_leg(tl: Timeline, t, s) -> dict:
    """T (best-effort) alone for CORES_SOLO_S, then S (latency-critical)
    loads, warms up and serves CORES_TIERED_S of waves beside it; T alone
    for CORES_TAIL_S; both exit and their slots must be cleared."""
    ft = t.go()
    await_file(t.ctl / "train_ready", [ft], "T ready (tiered)")
    time.sleep(CORES_SOLO_S)
    fs = s.go()
    await_file(s.ctl / f"{s.name}_ready", [ft, fs], "S ready (tiered)",
               limit=600)
    (s.ctl / f"{s.name}_go").touch()
    serve = fs.result()
    time.sleep(CORES_TAIL_S)
    (t.ctl / "train_stop").touch()
    trainer = ft.result()
    await_gc(tl, (t.label, s.label), "tiered leg")
    return {t.label: trainer, s.label: serve}


def coresidency_checks(record, tl: Timeline, legs: dict, rows: dict,
                       qos: dict, ticks: list) -> dict:
    """F1–F7 across phase_coresidency's legs, and their summary.  T's duty
    is read on three bases: the solo basis (steps x T's traced device time
    a step alone, over wall), the interposer's charge, and the traced
    kernel time of steps traced beside S."""
    from k8s_vgpu_scheduler_tpu_torch.shim import simlab

    tick = MONITOR_INTERVAL_S
    alone = [legs[k] for k in ALONE]
    ft, fs, meta = legs["uidF_train"], legs["uidF_serve"], legs["flat"]
    qt, qs = legs["uidQ_train"], legs["uidQ_serve"]
    T, S = "uidF_train", "uidF_serve"
    solo_ms = ft["traces"]["solo"]["busy_ms_per_step"]
    # F1: a priority-1 pod borrows an idle card.
    f1 = duty_over(ft["steps"], [meta["solo"]], solo_ms)
    first = tl.of(T, *meta["solo"])
    check(first and not any(x[SWITCH] for x in first),
          "F1: T's switch on before S's first launch")
    check(f1["solo"] > MIN_UNCAPPED_DUTY, f"F1: T's duty alone {f1}")
    # F2, F4: the switch follows S's bursts.
    windows, on_lat, off_lat = [], [], []
    for b in fs["bursts"]:
        before = tl.of(T, 0.0, b["start"])
        check(before and before[-1][SWITCH] == 0,
              "F2: T's switch on before S's burst")
        on = tl.first(T, b["start"], SWITCH, 1)
        off = tl.first(T, b["end"], SWITCH, 0)
        on_lat.append(on - b["start"])
        off_lat.append(off - b["end"])
        check(on_lat[-1] <= SWITCH_ON_TICKS * tick + TIMELINE_S,
              f"F2: T's switch on {on_lat[-1]:.3f} s after S's first "
              "prefill")
        check(all(x[SWITCH] for x in tl.of(T, on, b["end"])),
              "F2: T's switch fell while S launched")
        check(off_lat[-1] <= SWITCH_OFF_TICKS * tick + TIMELINE_S,
              f"F4: T's switch off {off_lat[-1]:.3f} s after S's last "
              "launch")
        windows.append((on, off))
    # F3: T held to its grant while S is active, on the solo basis.
    span = ft["traces"]["shared"]["span"]
    pieces = [p for w in windows for p in cut(w, span)]
    f3 = duty_over(ft["steps"], pieces, solo_ms)
    check(abs(f3["solo"] - CORES_SM_LIMIT / 100) <= TOL_DUTY_POINTS,
          f"F3: T's duty beside S {f3}, grant {CORES_SM_LIMIT}%")
    # F4: T borrows the card again in the second half of S's idle gap.
    gap = (fs["bursts"][0]["end"], fs["bursts"][1]["start"])
    half = ((gap[0] + gap[1]) / 2, gap[1])
    f4 = duty_over(ft["steps"], [half], solo_ms)
    check(not any(x[SWITCH] for x in tl.of(T, *half)),
          "F4: T's switch on in the second half of S's idle gap")
    check(f4["solo"] > MIN_UNCAPPED_DUTY,
          f"F4: T's duty in the second half of S's idle gap {f4}")
    # F5: sharing the card changes no result.
    solo = record["enforce"]["train_plain_0"]["losses"]
    for run in (ft, qt):
        check(run["losses"][:len(solo)] == solo,
              f"F5: T's losses {run['losses'][:len(solo)]} != alone {solo}")
    check(all(run["tokens"] == alone[0]["tokens"]
              for run in (*alone, fs, qs)),
          "F5: S's tokens beside T differ from S's alone")
    # F6: the sampler's throttled time and the monitor's GC.
    t_on = tl.on_seconds(T)
    check(rows[S]["throttled_seconds"] == 0,
          f"F6: S throttled {rows[S]['throttled_seconds']} s")
    check(abs(rows[T]["throttled_seconds"] - t_on) <= tick,
          f"F6: the sampler's {rows[T]['throttled_seconds']} s throttled "
          f"against the timeline's {t_on:.3f} s")
    for key in (*ALONE[1::2], T, S, "uidQ_train", "uidQ_serve"):
        # From its slot's first sighting (a fresh region is readable an
        # instant before the attaching process takes its slot) to the
        # pod's last stamp.
        pid = legs[key]["pid"]
        samples = tl.of(key, 0.0, legs[key]["end_t"])
        seen = next((i for i, x in enumerate(samples) if pid in x[PIDS]),
                    None)
        gone = [x for x in samples[seen or 0:] if pid not in x[PIDS]]
        check(seen is not None and not gone, f"F6: {key}'s slot (pid "
              f"{pid}) cleared while it lived: {gone[:3]}")
        check(not tl.of(key)[-1][PIDS] and tl.of(key)[-1][USED] == 0,
              f"F6: {key}'s slot left after it exited")
    # F7: the tiered leg holds each class to what it is entitled to.
    b = qs["bursts"][0]
    be = [st["charged_us"] for st in qt["steps"] if st["end"] <= b["end"]][-1] \
        - [st["charged_us"] for st in qt["steps"]
           if st["end"] <= b["start"]][-1]
    leg = dict(tiered=True, elapsed_s=b["end"] - b["start"],
               critical=dict(admitted_device_s=b["interposer"]["charged_us"]
                             / 1e6),
               best_effort=dict(admitted_device_s=be / 1e6))
    violations = simlab.serving_violations(leg, serve_core=CORES_SM_LIMIT,
                                           train_core=CORES_SM_LIMIT)
    check(not violations, f"F7: {violations}")
    tiered = tl.of("uidQ_serve", b["start"], b["end"] + tick)
    p99 = [v for t, _, p in ticks if b["start"] <= t <= b["end"] + tick
           for v in p.values()]
    waits = rows["uidQ_serve"]
    tiered_t = tl.of("uidQ_train", b["start"], b["end"] + tick)
    beside = [st["end"] - st["start"] for st in ft["steps"]
              if any(a <= st["start"] and st["end"] <= z for a, z in pieces)
              and not st["traced"]]
    # The interposer's cost in S's host-bound loop, pair by pair: the
    # median wave's wall with it less without, over its hooked launches.
    cost = []
    for plain, pre in zip(alone[0::2], alone[1::2]):
        a, b = serve_summary(plain), serve_summary(pre)
        launches = sum(x["interposer"]["launches"] for x in pre["bursts"])
        per_wave = launches / b["waves"]
        cost.append(dict(hooked_launches_per_wave=per_wave,
                         wave_s_added=b["wave_s"] - a["wave_s"],
                         us_per_hooked_launch=(b["wave_s"] - a["wave_s"])
                         * 1e6 / per_wave,
                         decode_tokens_per_s_ratio=b["decode_tokens_per_s"]
                         / a["decode_tokens_per_s"]))
    shared = ft["traces"]["shared"]
    return {
        "phase": "coresidency", "card": record["card"],
        "seconds": record["coresidency_s"],
        "switch": {"on_after_first_prefill_s": on_lat,
                   "off_after_last_launch_s": off_lat,
                   "tick_s": tick, "timeline_s": TIMELINE_S},
        "t_duty": {"alone": f1, "beside_s": f3, "idle_second_half": f4,
                   "solo_ms_per_step": solo_ms,
                   "traced_beside_s": shared["busy_share"],
                   "traced_beside_ms_per_step": shared["busy_ms_per_step"]},
        "t_step_ms": {
            "alone": 1e3 * statistics.median(
                st["end"] - st["start"] for st in ft["steps"]
                if meta["solo"][0] <= st["start"]
                and st["end"] <= meta["solo"][1]),
            "beside_s": 1e3 * statistics.median(beside)},
        "serve": {**{f"alone_{'pre' if i % 2 else 'plain'}_{i // 2}":
                     serve_summary(run) for i, run in enumerate(alone)},
                  "beside_t_flat": serve_summary(fs),
                  "beside_t_tiered": serve_summary(qs)},
        "interposer_decode_cost": cost,
        "sampler": {"t_throttled_s": rows[T]["throttled_seconds"],
                    "t_switch_on_s": t_on,
                    "s_throttled_s": rows[S]["throttled_seconds"]},
        "tiered": {"leg": leg, "violations": violations,
                   "s_weight_max": max(x[WEIGHT] for x in tiered),
                   "t_weight_min": min(x[WEIGHT] for x in tiered_t),
                   "t_yield_share": statistics.mean(
                       x[YIELD] for x in tiered_t),
                   "t_switch_on_share": statistics.mean(
                       x[SWITCH] for x in tiered_t),
                   "critical_p99_us_max": max(p99, default=None),
                   "s_wait_s": waits["qos_wait_seconds_total"],
                   "s_wait_hist": waits["qos_wait_hist"], **qos},
    }


def apply_json_patch(obj: dict, ops: list) -> dict:
    """What the apiserver makes of ``obj`` under a webhook's JSONPatch: a
    copy with each ``add`` applied in order (the only op the webhook
    writes)."""
    out = json.loads(json.dumps(obj))
    for op in ops:
        check(op["op"] == "add", f"JSONPatch op {op}")
        keys = [k.replace("~1", "/").replace("~0", "~")
                for k in op["path"].split("/")[1:]]
        parent = out
        for k in keys[:-1]:
            parent = parent[int(k)] if isinstance(parent, list) else parent[k]
        value, last = json.loads(json.dumps(op["value"])), keys[-1]
        if not isinstance(parent, list):
            parent[last] = value
        elif last == "-":
            parent.append(value)
        else:
            parent.insert(int(last), value)
    return out


def user_pod(name: str, uid: str, mib: int, priority: int, cores=None,
             annotations=None, cards: int = 1,
             namespace: str = "default") -> dict:
    """A pod as its user writes it: one container asking for ``cards``
    cards, ``mib`` of each one's memory (and ``cores`` of its compute
    where given) at ``priority``, by resources only."""
    limits = {"nvidia.com/gpu": str(cards), "nvidia.com/gpumem": str(mib),
              "nvidia.com/priority": str(priority)}
    if cores is not None:
        limits["nvidia.com/gpucores"] = str(cores)
    return {"metadata": {"name": name, "namespace": namespace, "uid": uid,
                         "annotations": dict(annotations or {})},
            "spec": {"containers": [{"name": name, "resources": {
                "limits": limits}}]}}


def schedule_pod(base: str, kube, pod: dict, node: str) -> dict:
    """One pod through the port's scheduler extender at ``base`` as the
    apiserver and kube-scheduler drive it: admit_pod, then place_pod.
    Returns the patch, the replies and the seconds each call took."""
    created, out = admit_pod(base, kube, pod)
    place_pod(base, created, node, out)
    return out


def filter_pod(base: str, pod: dict, node: str, offer=None) -> tuple:
    """/filter offering ``node`` (or the nodes ``offer`` lists): the reply
    and the seconds it took."""
    t0 = time.monotonic()
    status, reply = http(f"{base}/filter", {"Pod": pod,
                                            "NodeNames": offer or [node]})
    check(status == 200, f"{pod['metadata']['name']}: Filter answered "
          f"{status} {reply}")
    return reply, time.monotonic() - t0


def place_pod(base: str, pod: dict, node: str, out: dict,
              offer=None) -> None:
    """/filter offering ``node`` (or ``offer``), which must place the pod
    on ``node``, then /bind to it; the replies and seconds go into
    ``out``."""
    meta = pod["metadata"]
    out["filter"], out["filter_s"] = filter_pod(base, pod, node, offer)
    check(out["filter"]["NodeNames"] == [node] and not out["filter"]["Error"],
          f"{meta['name']}: Filter answered {out['filter']}")
    t0 = time.monotonic()
    status, out["bind"] = http(f"{base}/bind", {
        "PodName": meta["name"], "PodNamespace": meta["namespace"],
        "PodUID": meta["uid"], "Node": out["filter"]["NodeNames"][0]})
    out["bind_s"] = time.monotonic() - t0
    check(status == 200 and out["bind"] == {"Error": ""},
          f"{meta['name']}: Bind answered {status} {out['bind']}")


def review_pod(base: str, pod: dict) -> tuple:
    """An AdmissionReview of ``pod`` to /webhook: the status, the reply
    and the seconds it took."""
    meta = pod["metadata"]
    t0 = time.monotonic()
    status, review = http(f"{base}/webhook", {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": f"review-{meta['uid']}", "operation": "CREATE",
                    "namespace": meta["namespace"], "object": pod}})
    return status, review, time.monotonic() - t0


def admit_pod(base: str, kube, pod: dict) -> tuple:
    """An AdmissionReview of ``pod`` to /webhook, its patch applied and
    the pod created in ``kube``: the pod as created, and a record of the
    patch and the seconds."""
    import base64

    meta = pod["metadata"]
    out = {}
    status, review, out["webhook_s"] = review_pod(base, pod)
    check(status == 200 and review["response"]["allowed"]
          and review["response"].get("patchType") == "JSONPatch",
          f"{meta['name']}: the webhook answered {status} {review}")
    out["patch"] = json.loads(base64.b64decode(review["response"]["patch"]))
    return kube.create_pod(apply_json_patch(pod, out["patch"])), out


class ControlPlane:
    """The port's scheduler extender and a node agent's register stream,
    in this process, on ``kube``: a Scheduler (its informer on ``kube``'s
    pod events, its leases on ``clock``) with its register service on
    the unix socket ``sock``, a DeviceRegister streaming ``backend``'s
    cards to it as node ``cfg.node_name``, and the HTTP extender on
    127.0.0.1 at a port of its own.  Up once the scheduler holds the
    node's inventory."""

    def __init__(self, kube, backend, cfg, sock: Path, clock=None,
                 usage_source=None) -> None:
        from k8s_vgpu_scheduler_tpu_torch.cmd.scheduler import \
            start_register_service
        from k8s_vgpu_scheduler_tpu_torch.deviceplugin import DeviceRegister
        from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
        from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import \
            ExtenderServer

        self.scheduler = Scheduler(kube, cfg, clock=clock)
        self.scheduler.resync_from_apiserver()
        kube.watch_pods(self.scheduler.on_pod_event)
        self.closed = False
        self.grpc = start_register_service(self.scheduler, f"unix:{sock}",
                                           workers=4)
        self.register = DeviceRegister(backend, cfg, endpoint=f"unix:{sock}",
                                       usage_source=usage_source)
        self.http = ExtenderServer(self.scheduler, cfg, host="127.0.0.1",
                                   port=0)
        self.base = f"http://127.0.0.1:{self.http.port}"
        try:
            self.register.start()
            self.http.start()
            t0 = time.monotonic()
            while self.scheduler.nodes.get_node(cfg.node_name) is None:
                check(time.monotonic() - t0 < REGISTER_WAIT_S,
                      f"node {cfg.node_name} never registered")
                time.sleep(0.05)
            self.register_s = time.monotonic() - t0
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.register.stop()
        self.http.stop()
        self.grpc.stop(grace=1).wait()
        if self.register._thread is not None:
            self.register._thread.join(timeout=10)


def node_agent() -> int:
    """The port's node agent and scheduler extender on the card
    (``--enforce-child node_agent``), in a process that never imports
    torch: the card through NVML (``detect()``), one health poll; then the
    port's control plane on a FakeKube (ControlPlane: the scheduler, the
    register stream from these cards over a unix socket, the extender on
    127.0.0.1).  Each of the two PLUGIN_PODS is created with resources
    only, mutated by /webhook, placed by /filter and bound by /bind
    (schedule_pod), then answered by a GpuDevicePlugin's Allocate;
    NODE_AGENT_POLLS more polls.  Prints the cards, the inventory, the
    advertisement, what the scheduler registered, the polls and each pod's
    spec, handshake, response, bind phase and lock as one ENFORCE line,
    with the real node's fabric (fabric_checks) and MIG state
    (real_mig_checks), the mock HGX node's placements (hgx_leg), the
    mock MIG node's answers (mig_leg) and the daemons of charts/vgpu on
    these cards (chart_leg), all made once S and T are bound."""
    sys.path.insert(0, str(ROOT))
    import importlib.metadata

    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
        DeviceCache, GpuDevicePlugin, advertised_devices)
    from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
    from k8s_vgpu_scheduler_tpu_torch.tpulib import NvmlBackend, detect
    from k8s_vgpu_scheduler_tpu_torch.util import nodelock
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    tmp = Path(os.environ["PLUGIN_DIR"])
    t0 = time.monotonic()
    backend = detect()
    if not isinstance(backend, NvmlBackend):
        print(f"chip_smoke: FAIL: node_agent: detect() gave "
              f"{type(backend).__name__}, not NVML", file=sys.stderr)
        return 1
    plane = None
    try:
        cards = backend.cards()
        cache = DeviceCache(backend, heartbeat_seconds=0)
        polls = [cache.poll_once()]
        inv = cache.inventory
        cfg = Config(node_name=PLUGIN_NODE, shim_host_dir=str(tmp / "shim"),
                     cache_host_dir=str(tmp / "containers"))
        kube = FakeKube()
        kube.add_node({"metadata": {"name": PLUGIN_NODE, "annotations": {}}})
        plane = ControlPlane(kube, backend, cfg, tmp / "scheduler.sock")
        registered = [dataclasses.asdict(d) for d in
                      plane.scheduler.nodes.get_node(PLUGIN_NODE).devices]
        plugin = GpuDevicePlugin(
            kube, inv, dataclasses.replace(cfg, topology_policy=PLUGIN_POLICY),
            socket_dir=str(tmp))
        pods = {}
        for name, uid, mib, priority in PLUGIN_PODS:
            spec = user_pod(name, uid, mib, priority, cores=CORES_SM_LIMIT)
            handshake = schedule_pod(plane.base, kube, spec, PLUGIN_NODE)
            t_alloc = time.monotonic()
            [resp] = plugin.allocate(1)
            handshake["allocate_s"] = time.monotonic() - t_alloc
            pods[name] = dict(
                key=f"{uid}_{name}", grant_mib=mib, priority=priority,
                pod=kube.get_pod("default", name), handshake=handshake,
                response=dataclasses.asdict(resp),
                locked=nodelock.is_locked(kube, PLUGIN_NODE))
        fabric = fabric_checks(backend, plane, plugin, kube, inv)
        mig_real = real_mig_checks(kube, inv, cfg, cards, tmp)
        hgx = hgx_leg(plane, kube, tmp)
        mig = mig_leg(plane, kube, tmp)
        chart = chart_leg(tmp, {c["uuid"]: (c["memory_v2"]["total"]
                                            - c["memory_v2"]["reserved"]) >> 20
                                for c in cards})
        register_s = plane.register_s
        plane.close()
        plane = None
        for _ in range(NODE_AGENT_POLLS):
            time.sleep(0.5)
            polls.append(cache.poll_once())
        events = backend.events
        out = dict(
            backend=type(backend).__name__, cards=cards,
            inventory=[dataclasses.asdict(c) for c in inv.chips],
            advertised=advertised_devices(inv, cfg), registered=registered,
            register_s=register_s, polls=polls,
            events_registered=events.registered if events else None,
            events_unsupported=events.unsupported if events else None,
            events_error=backend.events_error, pods=pods, fabric=fabric,
            hgx=hgx, mig_real=mig_real, mig=mig, chart=chart, packages={})
        for dist in ("grpcio", "protobuf"):
            try:
                out["packages"][dist] = importlib.metadata.version(dist)
            except importlib.metadata.PackageNotFoundError:
                out["packages"][dist] = None
    except Fail as exc:
        print(f"chip_smoke: FAIL: node_agent: {exc}", file=sys.stderr)
        return 1
    finally:
        if plane is not None:
            plane.close()
        backend.close()
    out["torch_loaded"] = "torch" in sys.modules
    out["run_s"] = time.monotonic() - t0
    print("ENFORCE " + json.dumps(out), flush=True)
    return 0


def fabric_checks(backend, plane, plugin, kube, inv) -> dict:
    """The real node's fabric, in node_agent: NVML's P2P answers (with one
    card, the card with itself), the topology and coordinates the
    scheduler registered from the stream, kubelet's GetDevicePluginOptions
    and GetPreferredAllocation over the plugin's socket (each answer held
    to SliceAllocator.preferred on the same inventory, on the one card),
    and the unsatisfiable-sizes annotation under PLUGIN_POLICY (absent)."""
    import grpc

    from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_vgpu_scheduler_tpu_torch.api.kubelet import DevicePluginStub
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
        UNSATISFIABLE_ANNOTATION, SliceAllocator, publish_unsatisfiable)
    from k8s_vgpu_scheduler_tpu_torch.tpulib import nvml

    out = {"p2p": backend.last_fabric}
    h = backend.nvml.handle(0)
    try:
        status = backend.nvml.p2p_status(h, h)
        out["p2p_self"] = dict(status=status,
                               name=nvml.P2P_STATUS.get(status))
    except nvml.NvmlError as e:
        if e.code != nvml.ERROR_NOT_SUPPORTED:
            raise
        out["p2p_self"] = dict(not_supported=e.call)
    info = plane.scheduler.nodes.get_node(PLUGIN_NODE)
    topo = info.topology
    out["registered"] = dict(
        topology=topo and dict(generation=topo.generation,
                               mesh=list(topo.mesh),
                               wraparound=list(topo.wraparound)),
        coords=[list(d.coords) for d in info.devices])
    check(topo is not None
          and (topo.generation, topo.mesh, topo.wrap())
          == (inv.topology.generation, inv.topology.mesh,
              inv.topology.wrap())
          and out["registered"]["coords"]
          == [list(c.coords) for c in inv.chips],
          f"the scheduler registered {out['registered']}, the inventory "
          f"{inv.topology}")
    if len(inv.chips) == 1:
        check(topo.mesh == (1,) and out["registered"]["coords"] == [[0]],
              f"one card registered as {out['registered']}")
    every = [d.ID for d in plugin.api_devices()]
    asks = [(n, []) for n in PREFERRED_SIZES] + [(2, [every[-1]])]
    answers = []
    plugin.serve()
    try:
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            stub = DevicePluginStub(ch)
            t0 = time.monotonic()
            opts = stub.GetDevicePluginOptions(pb.Empty(), timeout=10)
            out["options_s"] = time.monotonic() - t0
            for size, must in asks:
                t0 = time.monotonic()
                resp = stub.GetPreferredAllocation(
                    pb.PreferredAllocationRequest(container_requests=[
                        pb.ContainerPreferredAllocationRequest(
                            available_deviceIDs=every,
                            must_include_deviceIDs=must,
                            allocation_size=size)]), timeout=10)
                answers.append(dict(
                    size=size, must=must,
                    ids=list(resp.container_responses[0].deviceIDs),
                    seconds=time.monotonic() - t0))
    finally:
        plugin.stop()
    check(opts.get_preferred_allocation_available,
          "GetDevicePluginOptions offers no preferred allocation")
    alloc = SliceAllocator(inv, PLUGIN_POLICY)
    for a in answers:
        want = alloc.preferred(every, a["must"], a["size"])
        cards = {i.rsplit("-", 1)[0] for i in a["ids"]}
        check(a["ids"] == want and len(want) == a["size"]
              and set(a["must"]) <= set(want)
              and (len(inv.chips) > 1 or cards == {inv.chips[0].uuid}),
              f"GetPreferredAllocation answered {a}, the allocator {want}")
    out["preferred"] = answers
    publish_unsatisfiable(kube, PLUGIN_NODE, inv, PLUGIN_POLICY)
    anns = kube.get_node(PLUGIN_NODE)["metadata"].get("annotations") or {}
    out["unsatisfiable"] = anns.get(UNSATISFIABLE_ANNOTATION)
    check(out["unsatisfiable"] is None,
          f"{UNSATISFIABLE_ANNOTATION} is {out['unsatisfiable']!r}")
    return out


def real_mig_checks(kube, inv, cfg, cards, tmp: Path) -> dict:
    """The real card's MIG state, in node_agent: NVML's answer (``mode``,
    current and pending, or None where the driver refuses the query as
    not supported, with the call named), and, under each of none and
    mixed, the partition plugins (none), the whole-card view, the
    register request and the devices kubelet's ListAndWatch gets over the
    plugin's socket, which must be equal: with MIG off, mixed changes
    nothing the node advertises."""
    from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_vgpu_scheduler_tpu_torch.api.kubelet import DevicePluginStub
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
        GpuDevicePlugin, get_partition_plugins, inventory_to_request,
        whole_chip_view)
    import grpc

    t0 = time.monotonic()
    out = {"nvml": cards[0]["mig"], "not_supported": [
        c for c in cards[0]["not_supported"] if "Mig" in c]}
    views = {}
    for strategy in ("none", "mixed"):
        c = dataclasses.replace(cfg, partition_strategy=strategy)
        parts = get_partition_plugins(strategy, inv, c, str(tmp))
        view = whole_chip_view(inv)
        plugin = GpuDevicePlugin(kube, view, c, socket_dir=str(tmp),
                                 socket_name=f"mig-{strategy}.sock")
        plugin.serve()
        try:
            with grpc.insecure_channel(
                    f"unix://{plugin.socket_path}") as channel:
                stream = DevicePluginStub(channel).ListAndWatch(
                    pb.Empty(), timeout=10)
                devices = [(d.ID, d.health) for d in next(iter(stream))
                           .devices]
                stream.cancel()
        finally:
            plugin.stop()
        views[strategy] = dict(
            plugins=len(parts), view=[chip.uuid for chip in view.chips],
            request=inventory_to_request(PLUGIN_NODE, inv, c)
            .SerializeToString().hex(), devices=devices)
    check(views["mixed"] == views["none"]
          and views["none"]["plugins"] == 0
          and views["none"]["view"] == [chip.uuid for chip in inv.chips],
          f"under mixed the node advertises {views['mixed']}, under none "
          f"{views['none']}")
    out["list_and_watch_devices"] = len(views["none"]["devices"])
    out["seconds"] = time.monotonic() - t0
    return out


def mig_leg(plane, kube, tmp: Path) -> dict:
    """The mock MIG node beside the real one, in node_agent: three
    agents on the mock NVML with MIG_FIXTURE, started together, each the
    entry point: under mixed, with its sockets in <tmp>/mig where this
    process serves kubelet's Registration; and two under single that must
    exit at start with their MIG_REFUSALS message.  As kubelet: the
    Register calls, ListAndWatch on every socket, GetPreferredAllocation
    (two 1g.10gb of seven; two 3g.40gb of three on two cards), Allocate of
    one 3g.40gb device and of an unknown ID, each timed; the scheduler's
    registration of the node and a whole-card pod's Filter."""
    import hashlib

    import grpc

    from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_vgpu_scheduler_tpu_torch.api.kubelet import (
        DevicePluginStub, add_registration_service)
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

    lib = _kernels.build_mock_nvml()
    chips = MIG_FIXTURE["chips"]
    migs = {f: [m["uuid"] for c in chips for m in c.get("mig", ())
                if (f == "3g.40gb") == (m["slices"] == 3)]
            for f in ("3g.40gb", "1g.10gb")}
    socks = tmp / "mig"
    socks.mkdir()
    received = []
    kubelet = grpc.server(ThreadPoolExecutor(max_workers=2))
    add_registration_service(kubelet, lambda request, context: (
        received.append((time.monotonic(), request)), pb.Empty())[1])
    kubelet.add_insecure_port(f"unix://{socks / 'kubelet.sock'}")
    kubelet.start()

    def args(strategy: str, node: str, *extra) -> list:
        return ["--fake-kube", "--node-name", node, "--socket-dir",
                str(socks if strategy == "mixed" else tmp / node),
                "--scheduler-endpoint", f"unix:{tmp / 'scheduler.sock'}",
                "--partition-strategy", strategy, "--shim-dir",
                str(tmp / "shim"), "--cache-dir", str(tmp / "mig_containers"),
                "--config-file", str(tmp / "no_config.json"), *extra]

    out: dict = {}
    sched = plane.scheduler
    t0 = time.monotonic()
    agents = {"mixed": start_mock_agent(kube, MIG_NODE, MIG_FIXTURE, lib, tmp,
                                        args("mixed", MIG_NODE))}
    for name, extra in (("subset", ("--partition-chips", chips[0]["uuid"])),
                        ("flavors", ())):
        (tmp / f"mig-{name}").mkdir()
        agents[name] = start_mock_agent(
            kube, f"mig-{name}", MIG_FIXTURE, lib, tmp,
            args("single", f"mig-{name}", *extra))
    try:
        agent = agents["mixed"]
        while len(received) < len(MIG_REGISTERED):
            check(agent.poll() is None,
                  f"the MIG agent exited {agent.returncode}")
            check(time.monotonic() - t0 < REGISTER_WAIT_S,
                  f"kubelet got {len(received)} Register calls")
            time.sleep(0.02)
        out["kubelet_register_s"] = max(t for t, _ in received) - t0
        out["registered"] = sorted((r.resource_name, r.endpoint)
                                   for _, r in received)
        check(out["registered"] == MIG_REGISTERED
              and all(r.options.get_preferred_allocation_available
                      for _, r in received),
              f"kubelet's Register calls {out['registered']}")
        reg = out["scheduler"] = registered(sched, MIG_NODE, agent)
        ids = [d.id for d in sched.nodes.get_node(MIG_NODE).devices]
        check(ids == [chips[3]["uuid"]],
              f"the scheduler registered {ids} of the MIG node")

        def rpc(sock: str, call: str, request):
            t = time.monotonic()
            with grpc.insecure_channel(f"unix://{socks / sock}") as ch:
                stub = DevicePluginStub(ch)
                if call == "ListAndWatch":
                    stream = stub.ListAndWatch(request, timeout=10)
                    reply = next(iter(stream))
                    stream.cancel()
                else:
                    reply = getattr(stub, call)(request, timeout=10)
            return reply, time.monotonic() - t

        lw = out["list_and_watch"] = {}
        for res, sock in MIG_REGISTERED:
            reply, seconds = rpc(sock, "ListAndWatch", pb.Empty())
            lw[res] = dict(ids=[d.ID for d in reply.devices],
                           healthy=all(d.health == "Healthy"
                                       for d in reply.devices),
                           seconds=seconds)
        check(lw["nvidia.com/mig-3g.40gb"]["ids"] == migs["3g.40gb"]
              and lw["nvidia.com/mig-1g.10gb"]["ids"] == migs["1g.10gb"]
              and lw["nvidia.com/gpu"]["ids"] == [
                  f"{chips[3]['uuid']}-{k}" for k in range(10)]
              and all(v["healthy"] for v in lw.values()),
              f"ListAndWatch on the MIG node: {lw}")
        created, rec = admit_pod(plane.base, kube, user_pod(
            "migwhole", "uidMW", HGX_MIB, 1, cores=100,
            cards=MIG_WHOLE_CARDS))
        rec["filter"], rec["filter_s"] = filter_pod(plane.base, created,
                                                    MIG_NODE)
        out["whole_pod"] = rec
        check(not rec["filter"]["NodeNames"],
              f"a {MIG_WHOLE_CARDS}-card pod on the MIG node: "
              f"{rec['filter']}")
        kube.delete_pod("default", "migwhole")
        pref = out["preferred"] = []
        for sock, avail in (("vgpu-1g.10gb.sock", migs["1g.10gb"]),
                            ("vgpu-3g.40gb.sock", migs["3g.40gb"][1:])):
            reply, seconds = rpc(sock, "GetPreferredAllocation",
                                 pb.PreferredAllocationRequest(
                                     container_requests=[
                                         pb.ContainerPreferredAllocationRequest(
                                             available_deviceIDs=avail,
                                             allocation_size=2)]))
            pref.append(dict(sock=sock, available=avail, seconds=seconds,
                             ids=list(reply.container_responses[0]
                                      .deviceIDs)))
        check(pref[0]["ids"] == migs["1g.10gb"][:2]
              and pref[1]["ids"] == migs["3g.40gb"][2:4],
              f"GetPreferredAllocation on the MIG node: {pref}")
        one = migs["3g.40gb"][0]
        reply, seconds = rpc("vgpu-3g.40gb.sock", "Allocate",
                             pb.AllocateRequest(container_requests=[
                                 pb.ContainerAllocateRequest(
                                     devicesIDs=[one])]))
        r = reply.container_responses[0]
        envs = dict(r.envs)
        mounts = {m.container_path: m.host_path for m in r.mounts}
        key = "part-" + hashlib.sha1(one.encode()).hexdigest()[:12]
        out["allocate"] = dict(id=one, envs=envs, mounts=mounts,
                               seconds=seconds)
        check(envs.get("NVIDIA_VISIBLE_DEVICES") == one
              and envs.get("CUDA_DEVICE_MEMORY_LIMIT_0") == str(MIG_3G_MIB)
              and "CUDA_DEVICE_SM_LIMIT" not in envs
              and mounts.get("/tmp/vgpu") == str(tmp / "mig_containers"
                                                 / key)
              and (tmp / "mig_containers" / key).is_dir(),
              f"Allocate of {one}: {envs}, {mounts}")
        t = time.monotonic()
        try:
            rpc("vgpu-3g.40gb.sock", "Allocate", pb.AllocateRequest(
                container_requests=[pb.ContainerAllocateRequest(
                    devicesIDs=["MIG-unknown"])]))
            code = None
        except grpc.RpcError as e:
            code = e.code().name
        out["unknown"] = dict(code=code, seconds=time.monotonic() - t)
        check(code == "INVALID_ARGUMENT",
              f"Allocate of an unknown ID answered {code}")
    finally:
        ends = {}
        t_stop = time.monotonic()
        for name, agent in agents.items():
            try:
                stdout, stderr = agent.communicate("", timeout=30)
            except subprocess.TimeoutExpired:
                agent.kill()
                stdout, stderr = agent.communicate()
            ends[name] = (agent.returncode, stdout, stderr)
        out["stop_s"] = time.monotonic() - t_stop
        kubelet.stop(grace=1)
    rc, stdout, stderr = ends.pop("mixed")
    check(rc == 0, f"the MIG agent exited {rc}: {stderr.strip()[-2000:]}")
    line = [x for x in stdout.splitlines() if x.startswith("ENFORCE ")]
    check(len(line) == 1 and not json.loads(line[0][8:])["torch_loaded"],
          f"the MIG agent printed {line}")
    out["refusals"] = {}
    for name, (rc, _, stderr) in ends.items():
        said = [x for x in stderr.splitlines() if MIG_REFUSALS[name] in x]
        out["refusals"][name] = dict(rc=rc, message=said[-1] if said else
                                     stderr.strip()[-400:])
        check(rc != 0 and said,
              f"single ({name}) exited {rc}: {stderr.strip()[-2000:]}")
    out["run_s"] = time.monotonic() - t0
    return out


def start_mock_agent(kube, node: str, fixture: dict, lib: Path,
                     tmp: Path, args=None):
    """A node agent (mock_agent) on the mock NVML, streaming ``fixture``'s
    cards to the scheduler on <tmp>/scheduler.sock as ``node``; with
    ``args``, the entry point (vgpu-device-plugin ``args``) with the mock
    first on the library path."""
    path = tmp / f"{node}_nvml.json"
    path.write_text(json.dumps(fixture))
    kube.add_node({"metadata": {"name": node, "annotations": {}}})
    env = {k: v for k, v in os.environ.items()
           if k not in ("MOCK_NVML_NOT_SUPPORTED", "VTPU_MOCK_JSON")}
    env.update(MOCK_NVML_JSON=str(path), MOCK_NVML_LIB=str(lib),
               PLUGIN_DIR=str(tmp), MOCK_NODE=node)
    if args is not None:
        env["MOCK_AGENT_ARGS"] = json.dumps(args)
        env["LD_LIBRARY_PATH"] = os.pathsep.join(
            p for p in (str(lib.parent), env.get("LD_LIBRARY_PATH")) if p)
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--enforce-child",
         "mock_agent"], env=env, cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def registered(sched, node: str, agent) -> dict:
    """Wait for ``node``'s registration: the seconds, the topology, each
    card's coordinates and the memory sizes the scheduler holds."""
    t0 = time.monotonic()
    while sched.nodes.get_node(node) is None:
        check(agent.poll() is None,
              f"the agent of {node} exited {agent.returncode}")
        check(time.monotonic() - t0 < REGISTER_WAIT_S,
              f"{node} never registered")
        time.sleep(0.05)
    seconds = time.monotonic() - t0
    info = sched.nodes.get_node(node)
    topo = info.topology
    return dict(register_s=seconds, topology=topo and dict(
        generation=topo.generation, mesh=list(topo.mesh),
        wraparound=list(topo.wraparound)),
        coords=[list(d.coords) for d in info.devices],
        devmem=sorted({d.devmem for d in info.devices}))


def stop_mock_agent(agent, node: str) -> dict:
    """Close the agent's stdin (its end) and read its ENFORCE line."""
    try:
        stdout, stderr = agent.communicate("", timeout=30)
    except subprocess.TimeoutExpired:
        agent.kill()
        stdout, stderr = agent.communicate()
    check(agent.returncode == 0, f"the agent of {node} exited "
          f"{agent.returncode}: {stderr.strip()[-2000:]}")
    line = [x for x in stdout.splitlines() if x.startswith("ENFORCE ")]
    check(len(line) == 1, f"the agent of {node} printed no result")
    out = json.loads(line[0][len("ENFORCE "):])
    check(not out["torch_loaded"], f"the agent of {node} imported torch")
    return out


def hgx_leg(plane, kube, tmp: Path) -> dict:
    """The mock nodes beside the real one, in node_agent once S and T
    are bound: two node agents (mock_agent) on the mock NVML stream
    HGX_FIXTURE's eight NVSwitch cards and PCIE_FIXTURE's four PCIe cards
    to the same scheduler; then HGX_PODS through the webhook, Filter
    (offered the real and the HGX node) and Bind, the mesh pod deleted
    before the 3-card pod, a malformed mesh through the webhook, and
    PCIE_PODS offered the PCIe node alone; then every pod deleted, and
    their grants must be freed."""
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.topology import is_contiguous
    from k8s_vgpu_scheduler_tpu_torch.util import codec, nodelock

    lib = _kernels.build_mock_nvml()
    agents = {node: start_mock_agent(kube, node, fx, lib, tmp)
              for node, fx in ((HGX_NODE, HGX_FIXTURE),
                               (PCIE_NODE, PCIE_FIXTURE))}
    out: dict = {}
    sched = plane.scheduler

    def freed(uids) -> None:
        t0 = time.monotonic()
        while any(sched.pods.get(u) is not None for u in uids):
            check(time.monotonic() - t0 < REGISTER_WAIT_S,
                  f"the informer kept the grants of {uids}")
            time.sleep(0.01)

    def granted(name: str) -> list:
        pod = kube.get_pod("default", name)
        [grants] = codec.decode_pod_devices(
            pod["metadata"]["annotations"]["vtpu.dev/assigned-ids"])
        return [g.uuid for g in grants]

    try:
        reg = out["registered"] = registered(sched, HGX_NODE,
                                             agents[HGX_NODE])
        out["register_s"] = reg["register_s"]
        topo = sched.nodes.get_node(HGX_NODE).topology
        coord_of = {d.id: d.coords
                    for d in sched.nodes.get_node(HGX_NODE).devices}
        check(topo is not None and (topo.mesh, topo.wrap()) == ((8,), (True,))
              and reg["coords"] == [[i] for i in range(8)]
              and reg["devmem"] == [HGX_FIXTURE["hbm_mib"]],
              f"the HGX node registered {reg}")
        offer = [PLUGIN_NODE, HGX_NODE]
        pods = out["pods"] = {}
        for name, uid, cards, anns in HGX_PODS:
            if name == "arc3":
                kube.delete_pod("default", "mesh2")
                freed(["uidXM"])
            created, rec = admit_pod(plane.base, kube, user_pod(
                name, uid, HGX_MIB, 1, cores=100, annotations=anns,
                cards=cards))
            pods[name] = rec
            if name == "arc3":
                rec["filter"], rec["filter_s"] = filter_pod(
                    plane.base, created, HGX_NODE, offer)
                why = rec["filter"]["FailedNodes"].get(HGX_NODE, "")
                check(not rec["filter"]["NodeNames"]
                      and why.startswith("no-ici-slice:"),
                      f"arc3: Filter answered {rec['filter']}")
                continue
            place_pod(plane.base, created, HGX_NODE, rec, offer)
            nodelock.release_node(kube, HGX_NODE)  # the node's Allocate
            coords = [coord_of[u] for u in granted(name)]
            rec["cards"] = [c[0] for c in coords]
            check(len(set(coords)) == cards
                  and is_contiguous(coords, topo),
                  f"{name}: Filter granted cards {rec['cards']}")
        status, review, seconds = review_pod(plane.base, user_pod(
            "badmesh", "uidXB", HGX_MIB, 1, cores=100, cards=2,
            annotations={"vtpu.dev/mesh": BAD_MESH}))
        resp = review["response"]
        out["bad_mesh"] = dict(status=resp.get("status"), webhook_s=seconds)
        check(status == 200 and not resp["allowed"]
              and resp["status"]["code"] == 422
              and resp["status"]["message"] == BAD_MESH_MESSAGE,
              f"the webhook answered the malformed mesh {review}")

        # The PCIe node: no fabric, so a guaranteed or mesh pod is refused
        # there and a plain pod takes the plain choice.
        reg = out["pcie_registered"] = registered(sched, PCIE_NODE,
                                                  agents[PCIE_NODE])
        check(reg["topology"] is not None
              and reg["topology"]["mesh"] == [4]
              and reg["coords"] == [[]] * 4,
              f"the PCIe node registered {reg}")
        known = sorted(list(t.mesh) for t in sched.known_topologies())
        out["known_topologies"] = known
        check(known == [[1], [8]], f"the fleet's fabrics: {known}")
        uuids = {d.id for d in sched.nodes.get_node(PCIE_NODE).devices}
        for name, uid, cards, anns, token in PCIE_PODS:
            created, rec = admit_pod(plane.base, kube, user_pod(
                name, uid, HGX_MIB, 1, cores=100, annotations=anns,
                cards=cards))
            pods[name] = rec
            if token:
                rec["filter"], rec["filter_s"] = filter_pod(
                    plane.base, created, PCIE_NODE)
                why = rec["filter"]["FailedNodes"].get(PCIE_NODE, "")
                check(not rec["filter"]["NodeNames"]
                      and why.startswith(token + ":"),
                      f"{name}: Filter answered {rec['filter']}")
                continue
            place_pod(plane.base, created, PCIE_NODE, rec)
            nodelock.release_node(kube, PCIE_NODE)
            got = granted(name)
            rec["cards"] = len(set(got))
            check(len(set(got)) == cards and set(got) <= uuids,
                  f"{name}: Filter granted {got}")
        for name in ("ring4", "pin", "arc3") + tuple(
                p[0] for p in PCIE_PODS):
            kube.delete_pod("default", name)
        freed([uid for _, uid, _, _ in HGX_PODS]
              + [p[1] for p in PCIE_PODS])
        for node in agents:
            usage = sched.get_nodes_usage([node])[node][1]
            check(not any(u.used_slots or u.used_mem or u.used_cores
                          for u in usage.values()),
                  f"the cards of {node} are still granted")
    finally:
        ends = {}
        for node, agent in agents.items():  # stops every agent
            try:
                ends[node] = stop_mock_agent(agent, node)
            except Exception as e:  # noqa: BLE001 — raised after the rest
                ends[node] = e
    for node, end in ends.items():
        if isinstance(end, Exception):
            raise end
    out["agent"], out["pcie_agent"] = ends[HGX_NODE], ends[PCIE_NODE]
    check(out["agent"]["fabric"]["kind"] == "nvlink",
          f"the HGX agent: {out['agent']}")
    check(out["pcie_agent"]["fabric"]["kind"] == "none"
          and out["pcie_agent"]["coords"] == [[]] * 4,
          f"the PCIe agent: {out['pcie_agent']}")
    return out


def chart_rendering() -> dict:
    """charts/vgpu rendered with its default values (tests/gotmpl.py, the
    repo's stand-in for ``helm template``; it needs PyYAML, so the quota
    values stay empty unless ``import yaml`` works, and they are empty
    here: the extender reads a rendered quota.yaml with PyYAML): the three
    daemons' containers (``command``, ``env``, ``volumeMounts``), the
    DaemonSet's hostPath volumes, the kube-scheduler's extender config
    and profile, the node ConfigMap's ``config.json``, the TLS secret's
    mount and the webhook's service."""
    import importlib.util

    import yaml

    # By its path: tests/ is no package, and a site-packages `tests` may
    # shadow it.
    spec = importlib.util.spec_from_file_location(
        "gotmpl", ROOT / "tests" / "gotmpl.py")
    gotmpl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gotmpl)
    docs = [d for text in gotmpl.render_chart(
        str(CHART), release_name=CHART_RELEASE[0],
        namespace=CHART_RELEASE[1]).values()
        for d in yaml.safe_load_all(text) if d]
    by_kind = {}
    for d in docs:
        by_kind.setdefault(d["kind"], []).append(d)
    [dep] = by_kind["Deployment"]
    [ds] = by_kind["DaemonSet"]
    [hook] = by_kind["MutatingWebhookConfiguration"]
    maps = {d["metadata"]["name"]: d["data"] for d in by_kind["ConfigMap"]}
    dep_spec = dep["spec"]["template"]["spec"]
    ds_spec = ds["spec"]["template"]["spec"]
    containers = {c["name"]: c for c in dep_spec["containers"]
                  + ds_spec["containers"]}
    sched_cfg = yaml.safe_load(next(
        m["config.yaml"] for m in maps.values() if "config.yaml" in m))
    node_cfg = next(m["config.json"] for m in maps.values()
                    if "config.json" in m)
    volumes = {v["name"]: v for v in dep_spec["volumes"] + ds_spec["volumes"]}
    return dict(
        containers={name: containers[name] for name in (
            "vgpu-extender", "device-plugin", "monitor")},
        volumes=volumes, extender=sched_cfg["extenders"][0],
        scheduler_name=sched_cfg["profiles"][0]["schedulerName"],
        node_config=node_cfg, webhook=hook["webhooks"][0]["clientConfig"])


def argv_flags(argv: list) -> dict:
    """``--flag=value`` (value None for a bare ``--flag``) of a rendered
    command line, after ``python -m <module>``."""
    out = {}
    for tok in argv[3:]:
        flag, eq, value = tok.partition("=")
        out[flag] = value if eq else None
    return out


def chart_mapping(r: dict, root: Path, node: str) -> tuple:
    """CHART_MAP applied to the rendering: (table, argvs, envs, paths).
    ``table`` has one row per mapped value, [where, rendered, here];
    ``argvs`` and ``envs`` the three daemons' command lines and
    environments as they run here; ``paths`` the host directories by
    their role.  Checks on the way that the chart ties its parts
    together: the agent's endpoint is the extender's gRPC port behind its
    service, the agent's usage source the monitor's RPC port, each path
    flag a hostPath the container mounts, the config file and the TLS pair
    mounts of their ConfigMap and Secret."""
    c = r["containers"]
    flags = {name: argv_flags(c[name]["command"]) for name in c}
    ext, dp, mon = (flags[n] for n in (
        "vgpu-extender", "device-plugin", "monitor"))
    table = [["python", c["vgpu-extender"]["command"][0], sys.executable]]
    port = {name: free_port() for name in (
        "http", "grpc", "ext_metrics", "mon_metrics", "mon_grpc")}
    grpc_port = ext["--grpc-bind"].rpartition(":")[2]
    svc, _, ep_port = dp["--scheduler-endpoint"].rpartition(":")
    check(ep_port == grpc_port and svc == "{}.{}.svc".format(
        r["webhook"]["service"]["name"], r["webhook"]["service"]["namespace"]),
        f"the agent's endpoint {dp['--scheduler-endpoint']} is not the "
        f"extender's gRPC port {grpc_port} behind its service")
    check(dp["--usage-from"] == f"127.0.0.1:{mon['--grpc-port']}",
          f"the agent reads usage from {dp['--usage-from']}, the monitor "
          f"serves NodeTPUInfo on {mon['--grpc-port']}")
    here = {
        ("vgpu-extender", "--http-bind"): f"127.0.0.1:{port['http']}",
        ("vgpu-extender", "--grpc-bind"): f"127.0.0.1:{port['grpc']}",
        ("vgpu-extender", "--metrics-port"): str(port["ext_metrics"]),
        ("device-plugin", "--scheduler-endpoint"):
            f"127.0.0.1:{port['grpc']}",
        ("device-plugin", "--usage-from"): f"127.0.0.1:{port['mon_grpc']}",
        ("monitor", "--metrics-port"): str(port["mon_metrics"]),
        ("monitor", "--grpc-port"): str(port["mon_grpc"]),
        ("monitor", "--grpc-bind"): "127.0.0.1",
    }
    paths, hostpaths = {}, {}
    for name, flag in (("device-plugin", "--socket-dir"),
                       ("device-plugin", "--shim-dir"),
                       ("device-plugin", "--cache-dir"),
                       ("monitor", "--container-root")):
        rendered = flags[name][flag]
        vol = [r["volumes"][m["name"]] for m in c[name]["volumeMounts"]
               if m["mountPath"] == rendered]
        check(len(vol) == 1 and vol[0].get("hostPath", {}).get("path")
              == rendered, f"{name} {flag}={rendered} is no hostPath it "
              "mounts there")
        # Short: a unix socket's path must fit in 107 bytes.
        host = hostpaths.setdefault(rendered, root / "h" / str(len(hostpaths)))
        here[name, flag] = str(host)
        paths[flag] = host
        paths[flag].mkdir(parents=True, exist_ok=True)
    check(paths["--cache-dir"] == paths["--container-root"],
          "the agent's cache dir is not the monitor's container root")
    cfg = dp["--config-file"]
    [m] = [m for m in c["device-plugin"]["volumeMounts"]
           if cfg.startswith(m["mountPath"] + "/")]
    check("configMap" in r["volumes"][m["name"]],
          f"{cfg} is not mounted from the node ConfigMap")
    config = root / "config" / cfg.rpartition("/")[2]
    config.parent.mkdir()
    config.write_text(r["node_config"])
    here["device-plugin", "--config-file"] = str(config)
    tls = None
    if shutil.which("openssl"):
        tls = root / "tls"
        tls.mkdir()
        made = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-days", "1", "-subj", f"/CN={svc}", "-addext",
             f"subjectAltName=DNS:{svc},IP:127.0.0.1",
             "-keyout", str(tls / "tls.key"), "-out", str(tls / "tls.crt")],
            capture_output=True, text=True, timeout=60)
        check(made.returncode == 0, f"openssl req: {made.stderr[-2000:]}")
        for flag, name in (("--cert-file", "tls.crt"),
                           ("--key-file", "tls.key")):
            [m] = [m for m in c["vgpu-extender"]["volumeMounts"]
                   if ext[flag].startswith(m["mountPath"] + "/")]
            check("secret" in r["volumes"][m["name"]],
                  f"{ext[flag]} is not mounted from the TLS secret")
            here["vgpu-extender", flag] = str(tls / name)
    dropped = set() if tls else {"--cert-file", "--key-file"}
    argvs, envs = {}, {}
    for name in c:
        argv = [sys.executable, *c[name]["command"][1:3]]
        for tok in c[name]["command"][3:]:
            flag, eq, value = tok.partition("=")
            if flag in dropped and name == "vgpu-extender":
                table.append([f"{name} {flag}", value, None])
                continue
            if (name, flag) in here:
                table.append([f"{name} {flag}", value, here[name, flag]])
                tok = f"{flag}={here[name, flag]}"
            argv.append(tok)
        if name != "monitor":
            argv.append("--fake-kube")
        argvs[name] = argv
        env = {}
        for e in c[name].get("env", ()):
            if "valueFrom" in e:
                check(e["valueFrom"] == {"fieldRef": {
                    "fieldPath": "spec.nodeName"}}, f"{name}: env {e}")
                table.append([f"{name} env {e['name']}", "spec.nodeName",
                              node])
                env[e["name"]] = node
            else:
                env[e["name"]] = e["value"]
        envs[name] = env
    paths["tls"] = tls
    return table, argvs, envs, paths


def dashboard_metrics(chart: Path = CHART) -> set:
    """The metric names the chart's dashboards and alert rules query:
    every identifier of their PromQL outside strings, label matchers,
    ranges and ``by (...)`` groups that is not a function, a keyword or a
    series Prometheus writes itself (of a ``label_values`` query, the
    first argument)."""
    import yaml

    exprs = []
    for path in sorted((chart / "dashboards").iterdir()):
        if path.suffix == ".json":
            dash = json.loads(path.read_text())
            exprs += [t["expr"] for p in dash["panels"]
                      for t in p["targets"]]
            exprs += [re.sub(r"^label_values\(([^,]+),.*\)$", r"\1",
                             v["query"])
                      for v in dash["templating"]["list"]]
        else:
            exprs += [rule["expr"] for g in yaml.safe_load(
                path.read_text())["groups"] for rule in g["rules"]]
    out = set()
    for e in exprs:
        e = re.sub(r'"(?:[^"\\]|\\.)*"', "", e)
        e = re.sub(r"\{[^}]*\}|\[[^\]]*\]", "", e)
        e = re.sub(r"\b(?:by|without|on|ignoring|group_left|group_right)"
                   r"\s*\([^)]*\)", "", e)
        out |= {n for n in re.findall(
            r"\b([a-zA-Z_:][a-zA-Z0-9_:]*)\b(?!\s*\()", e)
            if n not in PROMQL_KEYWORDS | SCRAPE_SERIES}
    return out


def family_of(name: str) -> str:
    """A sample's or a ``# TYPE`` line's family: the name less ``_total``
    (a counter), ``_bucket``, ``_sum`` or ``_count`` (a histogram)."""
    return re.sub(r"_(total|bucket|sum|count)$", "", name)


def chart_leg(tmp: Path, cards: dict, env=None) -> dict:
    """The port's chart on this host, in node_agent beside hgx_leg and
    mig_leg: charts/vgpu rendered (chart_rendering), its three daemons
    mapped (chart_mapping; the table is printed on a line of its own) and
    started as processes with a kubelet Registration service in the
    mapped socket dir; the agent reads ``cards`` ({UUID: MiB}, NVML's
    total less reserved) through NVML.  Checks: all three stay up; the
    agent registers with the extender within CHART_REGISTER_S of its
    start and ``/fleetz`` holds ``cards``; kubelet gets a Register for
    the extender's first managed resource; the shim dir holds the
    interposer byte for byte as ``build_interposer()`` built it, its
    ``ld.so.preload`` and the startup hook; the webhook at the chart's
    path patches a one-card pod to the chart's scheduler and the chart's
    filterVerb places it on the node; every family the dashboards and
    alerts name (but the serving pod's) has a ``# TYPE`` line in the
    extender's or the monitor's scrape; each daemon ends on SIGTERM within
    CHART_STOP_S.  Logs in ``<tmp>/chart/<daemon>.log``."""
    import base64
    import signal
    import ssl

    import grpc

    from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_vgpu_scheduler_tpu_torch.api.kubelet import \
        add_registration_service
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.util.types import (
        PRELOAD_FILE, SHIM_CONTAINER_DIR, SHIM_LIBRARY)

    t_leg = time.monotonic()
    root = tmp / "chart"
    root.mkdir()
    r = chart_rendering()
    interposer = _kernels.build_interposer().read_bytes()
    table, argvs, envs, paths = chart_mapping(r, root, CHART_NODE)
    log("chart mapping:", json.dumps({"rules": CHART_MAP, "table": table}))
    out: dict = {"render": "tests/gotmpl.py", "mapping": table,
                 "tls": "openssl" if paths["tls"] else
                 "dropped: no openssl on PATH"}
    base_env = {k: v for k, v in (env or os.environ).items()
                if k != "VTPU_MOCK_JSON"}
    received = []
    kubelet = grpc.server(ThreadPoolExecutor(max_workers=2))
    add_registration_service(kubelet, lambda request, context: (
        received.append((time.monotonic(), request)), pb.Empty())[1])
    kubelet.add_insecure_port(
        f"unix://{paths['--socket-dir'] / 'kubelet.sock'}")
    kubelet.start()
    procs, logs = {}, {}
    ext = argv_flags(argvs["vgpu-extender"])
    scheme = "https" if paths["tls"] else "http"
    base = f"{scheme}://{ext['--http-bind']}"
    ctx = (ssl.create_default_context(cafile=str(paths["tls"] / "tls.crt"))
           if paths["tls"] else None)
    mon = argv_flags(argvs["monitor"])
    metrics = {"extender": f"http://127.0.0.1:{ext['--metrics-port']}"
                           "/metrics",
               "monitor": f"http://127.0.0.1:{mon['--metrics-port']}"
                          "/metrics"}

    def start(name: str) -> float:
        logs[name] = open(root / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            argvs[name], env={**base_env, **envs[name]}, cwd=ROOT,
            stdin=subprocess.DEVNULL, stdout=logs[name],
            stderr=subprocess.STDOUT)
        return time.monotonic()

    def alive(what: str) -> None:
        for name, p in procs.items():
            if p.poll() is not None:
                logs[name].flush()
                raise Fail(f"chart leg: {name} exited {p.returncode} "
                           f"{what}: "
                           f"{(root / f'{name}.log').read_text()[-3000:]}")

    def wait(what: str, get, limit: float = 30.0):
        t0 = time.monotonic()
        while True:
            alive(what)
            try:
                got = get()
            except OSError:
                got = None
            if got:
                return got
            check(time.monotonic() - t0 < limit, f"chart leg: {what}")
            time.sleep(0.05)

    def fleet():
        status, body = http(f"{base}/fleetz", timeout=5, context=ctx)
        return body if status == 200 else None

    try:
        start("vgpu-extender")
        wait("the extender's /healthz", lambda: http(
            f"{base}/healthz", timeout=5, context=ctx)[0] == 200)
        start("monitor")
        wait("the monitor's /metrics", lambda: http(
            metrics["monitor"], timeout=5)[0] == 200)
        t_agent = start("device-plugin")
        export = wait("the agent's registration", lambda: next(
            (n for n in (fleet() or {}).get("nodes", ())
             if n["name"] == CHART_NODE and n["chips"]), None),
            limit=CHART_REGISTER_S)
        out["register_s"] = time.monotonic() - t_agent
        out["fleetz"] = {d["id"]: d["devmem"] for d in export["chips"]}
        check(out["fleetz"] == cards, f"chart leg: /fleetz shows "
              f"{out['fleetz']}, NVML {cards}")
        managed = [m["name"] for m in r["extender"]["managedResources"]]
        wait("kubelet's Register call", lambda: received, limit=10)
        out["kubelet_register_s"] = received[0][0] - t_agent
        out["kubelet"] = sorted(q.resource_name for _, q in received)
        check(out["kubelet"] == [managed[0]],
              f"chart leg: kubelet got Register for {out['kubelet']}")
        shim = paths["--shim-dir"]
        out["shim"] = sorted(p.name for p in shim.iterdir())
        check((shim / SHIM_LIBRARY).read_bytes() == interposer
              and (shim / PRELOAD_FILE).read_text()
              == f"{SHIM_CONTAINER_DIR}/{SHIM_LIBRARY}\n"
              and (shim / _kernels.HOOK_FILE).is_file(),
              f"chart leg: the shim dir holds {out['shim']}")
        # The chart's webhook path, then the chart's filterVerb under the
        # extender config's urlPrefix.
        name, uid, mib, priority = CHART_POD
        pod = user_pod(name, uid, mib, priority)
        t0 = time.monotonic()
        status, review = http(f"{base}{r['webhook']['service']['path']}", {
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": f"review-{uid}", "operation": "CREATE",
                        "namespace": "default", "object": pod}},
            timeout=30, context=ctx)
        out["webhook_s"] = time.monotonic() - t0
        check(status == 200 and review["response"]["allowed"],
              f"chart leg: the webhook answered {status} {review}")
        patch = json.loads(base64.b64decode(review["response"]["patch"]))
        created = apply_json_patch(pod, patch)
        check(created["spec"].get("schedulerName") == r["scheduler_name"],
              f"chart leg: the webhook's patch {patch}")
        prefix = r["extender"]["urlPrefix"]
        check(prefix == "https://127.0.0.1:{}".format(
            r["webhook"]["service"]["port"]),
            f"chart leg: the extender config's urlPrefix {prefix}")
        t0 = time.monotonic()
        status, reply = http(f"{base}/{r['extender']['filterVerb']}", {
            "Pod": created, "NodeNames": [CHART_NODE]}, timeout=30,
            context=ctx)
        out["filter_s"] = time.monotonic() - t0
        out["filter"] = reply
        check(status == 200 and reply["NodeNames"] == [CHART_NODE]
              and not reply["Error"],
              f"chart leg: {r['extender']['filterVerb']} answered "
              f"{status} {reply}")
        # The dashboards' families in the two scrapes.
        typed = {}
        for who, url in metrics.items():
            status, text = http(url, timeout=30)
            check(status == 200, f"chart leg: {url} answered {status}")
            typed[who] = {family_of(line.split()[2])
                          for line in text.splitlines()
                          if line.startswith("# TYPE ")}
        want = {family_of(n) for n in dashboard_metrics()
                if not n.startswith("vtpu_serve_")}
        missing = want - typed["extender"] - typed["monitor"]
        out["families"] = dict(dashboards=len(want), **{
            who: len(t) for who, t in typed.items()})
        check(not missing, f"chart leg: no # TYPE line for {missing}")
        alive("before SIGTERM")
        out["stop_s"] = {}
        for name in ("device-plugin", "monitor", "vgpu-extender"):
            t0 = time.monotonic()
            procs[name].send_signal(signal.SIGTERM)
            try:
                rc = procs[name].wait(timeout=CHART_STOP_S)
            except subprocess.TimeoutExpired:
                rc = None
            out["stop_s"][name] = time.monotonic() - t0
            check(rc == 0, f"chart leg: {name} answered SIGTERM with "
                  f"{rc} in {out['stop_s'][name]:.1f} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        kubelet.stop(grace=1)
    out["leg_s"] = time.monotonic() - t_leg
    return out


def mock_agent() -> int:
    """A mock node's agent (``--enforce-child mock_agent``), in a process
    that never imports torch: NvmlBackend over the mock NVML
    ($MOCK_NVML_LIB, reading $MOCK_NVML_JSON) streams its inventory to the
    scheduler on <PLUGIN_DIR>/scheduler.sock as $MOCK_NODE until its stdin
    closes.  Prints the fabric NVML showed and the inventory as one
    ENFORCE line."""
    sys.path.insert(0, str(ROOT))
    if os.environ.get("MOCK_AGENT_ARGS"):
        return mock_entry_point(json.loads(os.environ["MOCK_AGENT_ARGS"]))
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import DeviceRegister
    from k8s_vgpu_scheduler_tpu_torch.tpulib import NvmlBackend
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    sock = Path(os.environ["PLUGIN_DIR"]) / "scheduler.sock"
    backend = NvmlBackend(os.environ["MOCK_NVML_LIB"])
    try:
        inv = backend.inventory()
        register = DeviceRegister(
            backend, Config(node_name=os.environ["MOCK_NODE"]),
            endpoint=f"unix:{sock}")
        register.start()
        sys.stdin.read()  # the parent closes it when it is done
        register.stop()
        register._thread.join(timeout=10)
        out = dict(fabric=backend.last_fabric,
                   topology=dataclasses.asdict(inv.topology),
                   coords=[list(c.coords) for c in inv.chips],
                   boards=sorted({c.board for c in inv.chips}))
    finally:
        backend.close()
    out["torch_loaded"] = "torch" in sys.modules
    print("ENFORCE " + json.dumps(out), flush=True)
    return 0


def mock_entry_point(args: list) -> int:
    """vgpu-device-plugin's ``main(args)`` on the mock NVML (first on
    LD_LIBRARY_PATH, so ``detect()`` loads it as NVML) until stdin closes,
    when a thread sends this process SIGINT, as ^C does (a real signal
    cuts the agent's sleep short), and the agent stops its plugins.  A
    refusal at start exits non-zero with its message, as the entry point
    does."""
    import signal

    from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin

    def wait() -> None:
        sys.stdin.read()
        os.kill(os.getpid(), signal.SIGINT)

    threading.Thread(target=wait, daemon=True).start()
    device_plugin.main(args)
    print("ENFORCE " + json.dumps({"torch_loaded": "torch" in sys.modules}),
          flush=True)
    return 0


class OffsetClock:
    """The monotonic clock plus an offset a caller advances: the
    scheduler's lease clock, aged without waiting."""

    def __init__(self) -> None:
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


def control_plane() -> int:
    """phase_preempt's control plane (``--enforce-child control_plane``),
    up for the whole phase in a process that never imports torch: the card
    through NVML, the shim dir filled as ``vgpu-device-plugin
    --install-shim`` fills it, a DeviceCache polling it every second whose keepalives
    go down the register stream, the port's scheduler extender with
    ``enable_preemption`` and its leases on an OffsetClock (ControlPlane),
    and a GpuDevicePlugin, on a FakeKube.  Prints one JSON line once up
    (the extender's base URL, the card, the seconds to register and to
    install the shim, the shim dir's files), then
    answers one JSON line for each command line on stdin (``{"ok": ...}``
    or ``{"error": ...}``): ``create`` a pod, ``get`` or ``delete`` one by
    name (the fake apiserver's writes and reads, as a kubelet and an
    apiserver make them; ``namespace`` defaults to "default"), ``allocate``
    (kubelet's Allocate for the pod Bind left allocating), ``requested``
    (each victim's eviction request and the monotonic time it reached the
    apiserver), ``grants`` (the scheduler's registry), ``tick`` (one pass
    of the capacity queues' admission loop, its actions; the queues are
    ``$QUOTA_CONFIG``'s, read by ``vgpu-scheduler``'s loader, with
    QUOTA_GRACE_S and QUOTA_HEADROOM), ``blocked`` (the last tick's blocked
    heads and reasons), ``gangs`` (the gang registry: each group's
    members, placed members and ranks), and ``end``: the register stream closes, the
    lease clock moves into the Suspect window for one rescue sweep and
    past the Dead deadline for another, and the answer holds both sweeps'
    actions and the annotations of every pod that held a grant.  Its
    register stream carries the usage counters of the vgpu-monitor at
    ``$USAGE_FROM``, where set (``monitor_usage_source``, as ``vgpu-device-plugin
    --usage-from`` wires it; the keepalive every second), and its extender
    also serves the scheduler's exporter (the ready line's ``metrics``)
    and ``/debug`` (``enable_debug``)."""
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.cmd.scheduler import load_quota_config
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
        DeviceCache, GpuDevicePlugin)
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        monitor_usage_source
    from k8s_vgpu_scheduler_tpu_torch.scheduler.metrics import \
        start_metrics_server
    from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import \
        PREEMPT_ANNOTATION
    from k8s_vgpu_scheduler_tpu_torch.tpulib import NvmlBackend, detect
    from k8s_vgpu_scheduler_tpu_torch.util import nodelock
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    tmp = Path(os.environ["PLUGIN_DIR"])
    backend = detect()
    if not isinstance(backend, NvmlBackend):
        print(f"chip_smoke: FAIL: control_plane: detect() gave "
              f"{type(backend).__name__}, not NVML", file=sys.stderr)
        return 1
    # The shim dir, as vgpu-device-plugin --install-shim fills it.
    t0 = time.monotonic()
    _kernels.install_shim(tmp / "shim")
    install_s = time.monotonic() - t0
    cache = DeviceCache(backend, poll_seconds=1.0,
                        heartbeat_seconds=REGISTER_BEAT_S)
    clock = OffsetClock()
    cfg = Config(node_name=PLUGIN_NODE, shim_host_dir=str(tmp / "shim"),
                 cache_host_dir=str(tmp / "containers"),
                 enable_preemption=True, enable_debug=True,
                 quota_queues=load_quota_config(
                     os.environ.get("QUOTA_CONFIG", "")),
                 queue_reclaim_grace_s=QUOTA_GRACE_S,
                 queue_fleet_headroom=QUOTA_HEADROOM)
    kube = FakeKube()
    kube.add_node({"metadata": {"name": PLUGIN_NODE, "annotations": {}}})
    requested = {}

    def on_event(event, pod):
        meta = pod["metadata"]
        value = (meta.get("annotations") or {}).get(PREEMPT_ANNOTATION)
        if value and meta["uid"] not in requested:
            requested[meta["uid"]] = [value, time.monotonic()]

    kube.watch_pods(on_event)
    plane = metrics = None
    try:
        usage_from = os.environ.get("USAGE_FROM")
        plane = ControlPlane(kube, backend, cfg, tmp / "scheduler.sock",
                             clock=clock, usage_source=usage_from and
                             monitor_usage_source(usage_from))
        metrics = start_metrics_server(plane.scheduler, port=0,
                                       host="127.0.0.1")
        cache.subscribe("register", plane.register.push_update,
                        heartbeat=True)
        cache.start()
        sched = plane.scheduler
        # The node agent shares this process, so its own `allocate` span
        # lands in the extender's tracer beside the scheduler's (the
        # checks after V' tell them apart).
        plugin = GpuDevicePlugin(kube, cache.inventory, cfg)

        def allocate(_):
            t0 = time.monotonic()
            [resp] = plugin.allocate(1)
            return dict(allocate_s=time.monotonic() - t0,
                        response=dataclasses.asdict(resp),
                        locked=nodelock.is_locked(kube, PLUGIN_NODE))

        def delete(cmd):
            kube.delete_pod(cmd.get("namespace", "default"), cmd["name"])

        def grants(_=None):
            return sorted([p.uid, p.name]
                          for p in sched.pods.pods_on_node(PLUGIN_NODE))

        def end(_):
            held = grants()
            cache.stop()
            plane.close()  # the stream ends: the inventory goes, the lease stays
            leases = sched.leases
            clock.offset += cfg.lease_ttl_s + 5.0 - leases.age_of(PLUGIN_NODE)
            suspect = dict(age_s=leases.age_of(PLUGIN_NODE),
                           actions=sched.rescuer.sweep(), left=grants())
            clock.offset += (leases.cfg.dead_after_s + 5.0
                             - leases.age_of(PLUGIN_NODE))
            dead = dict(age_s=leases.age_of(PLUGIN_NODE),
                        actions=sched.rescuer.sweep(), left=grants())
            return dict(held=held, suspect=suspect, dead=dead,
                        registered=sched.nodes.get_node(PLUGIN_NODE)
                        is not None,
                        annotations={name: kube.get_pod("default", name)[
                            "metadata"]["annotations"] for _, name in held},
                        torch_loaded="torch" in sys.modules)

        ops = {"create": lambda cmd: kube.create_pod(cmd["pod"]),
               "get": lambda cmd: kube.get_pod(
                   cmd.get("namespace", "default"), cmd["name"]),
               "delete": delete, "allocate": allocate,
               "requested": lambda _: requested, "grants": grants,
               "tick": lambda _: sched.admission.tick(),
               "blocked": lambda _: sched.admission.blocked,
               "gangs": lambda _: {
                   key: {"members": sorted(g.members),
                         "placements": sorted(g.placements),
                         "ranks": g.ranks}
                   for key, g in sched.gangs.groups().items()},
               "end": end}
        chip = cache.inventory.chips[0]
        print(json.dumps({"base": plane.base, "uuid": chip.uuid,
                          "metrics": f"http://127.0.0.1:{metrics.port}"
                                     "/metrics",
                          "hbm_mib": chip.hbm_mib,
                          "register_s": plane.register_s,
                          "install_shim_s": install_s,
                          "shim_files": sorted(
                              p.name for p in (tmp / "shim").iterdir())}),
              flush=True)
        for line in sys.stdin:
            cmd = json.loads(line)
            try:
                out = {"ok": ops[cmd["op"]](cmd)}
            except Exception as exc:  # noqa: BLE001 — the parent reports it
                out = {"error": f"{type(exc).__name__}: {exc}"}
            print(json.dumps(out), flush=True)
            if cmd["op"] == "end":
                break
    except Fail as exc:
        print(f"chip_smoke: FAIL: control_plane: {exc}", file=sys.stderr)
        return 1
    finally:
        cache.stop()
        if metrics is not None:
            metrics.stop()
        if plane is not None:
            plane.close()
        backend.close()
    return 0


class PlaneChild:
    """The control_plane child, driven by this process as kube-scheduler,
    apiserver client and kubelet: its extender over HTTP at ``base``, the
    rest over its stdin and stdout (``call``).  A call that gets no answer
    within PLANE_CALL_S ends the child.  Its stderr goes to
    chiprun_out/enforce_control_plane.log."""

    def __init__(self, env: dict) -> None:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        self.log = open(out / "enforce_control_plane.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--enforce-child",
             "control_plane"], env=env, cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        try:
            self.ready = self._read("start")
        except BaseException:
            self.close()
            raise
        self.base, self.metrics = self.ready["base"], self.ready["metrics"]

    def _read(self, what: str) -> dict:
        timer = threading.Timer(PLANE_CALL_S, self.proc.kill)
        timer.start()
        try:
            line = self.proc.stdout.readline()
        finally:
            timer.cancel()
        check(bool(line), f"the control plane ended at {what} (exit "
              f"{self.proc.poll()}; chiprun_out/enforce_control_plane.log)")
        return json.loads(line)

    def call(self, op: str, **args):
        self.proc.stdin.write(json.dumps({"op": op, **args}) + "\n")
        self.proc.stdin.flush()
        out = self._read(op)
        check("error" not in out, f"control plane {op}: {out.get('error')}")
        return out["ok"]

    def create_pod(self, pod: dict) -> dict:
        return self.call("create", pod=pod)

    def get_pod(self, name: str, namespace: str = "default") -> dict:
        return self.call("get", name=name, namespace=namespace)

    def close(self) -> int:
        """End the child (after ``end``, it exits by itself): its exit
        code."""
        if not self.log.closed:
            try:
                self.proc.stdin.close()
            except BrokenPipeError:
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.log.close()
        return self.proc.returncode


def smi_rows(query: str) -> list:
    """nvidia-smi's rows for ``query`` (``--query-gpu`` or
    ``--query-compute-apps``), each a list of fields, no units."""
    res = subprocess.run(["nvidia-smi", query,
                          "--format=csv,noheader,nounits"], env=smi_env(),
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return [[f.strip() for f in line.split(",")]
            for line in res.stdout.strip().splitlines() if line.strip()]


def podinfo_text(annotations: dict) -> str:
    """kubelet's downward-API file of a pod's annotations: one
    ``key="value"`` line a key, sorted, the value quoted."""
    return "".join(f"{k}={json.dumps(v)}\n"
                   for k, v in sorted(annotations.items()))


def kubelet_env(pod: dict, resp: dict, volumes: Path) -> dict:
    """What a kubelet gives a pod's first container from the pod's spec and
    the device plugin's answer, and nothing else: the spec's env, the
    answer's env, the library the mounted /etc/ld.so.preload names as
    LD_PRELOAD, and the spec's downward-API volumes, written under
    ``volumes``.  Mounts are container paths mapped to host paths: a path
    under one is rewritten to the host's (no mount namespace here)."""
    mounts = {m["container_path"]: m["host_path"] for m in resp["mounts"]}
    ctr = pod["spec"]["containers"][0]
    for vol in pod["spec"].get("volumes", []):
        if "downwardAPI" not in vol:
            continue
        [mount] = [m for m in ctr.get("volumeMounts", [])
                   if m["name"] == vol["name"]]
        host_dir = volumes / pod["metadata"]["uid"] / vol["name"]
        host_dir.mkdir(parents=True)
        for item in vol["downwardAPI"]["items"]:
            check(item["fieldRef"]["fieldPath"] == "metadata.annotations",
                  f"downward-API item {item}")
            (host_dir / item["path"]).write_text(
                podinfo_text(pod["metadata"]["annotations"]))
        mounts[mount["mountPath"]] = str(host_dir)

    def host(path: str) -> str:
        for c, h in mounts.items():
            if path == c or path.startswith(c + "/"):
                return h + path[len(c):]
        return path

    env = {e["name"]: host(e["value"]) for e in ctr.get("env", [])}
    env.update({k: host(v) for k, v in resp["envs"].items()})
    preload = Path(mounts["/etc/ld.so.preload"]).read_text().split()
    env["LD_PRELOAD"] = ":".join(host(lib) for lib in preload)
    return env


def phase_device_plugin(torch, record, vgpu: Path):
    """The port's node agent and scheduler extender on the card.  (a)
    ``node_agent`` in a child that never imports torch: its NVML inventory
    held to nvidia-smi and to this process's TorchBackend, the memory it
    advertises to CUDA's size and what the port's scheduler registered
    from its stream, one healthy poll, each pod placed by the port's
    webhook, Filter and Bind (``placed``: no grant key comes from this
    script), each bind phase ``success`` with the node lock released,
    each pod's region dir made, and the card's used memory sampled
    through its life (no context); the fabric (fabric_checks, hgx_leg,
    fabric_summary): NVML's P2P answers beside nvidia-smi's ``topo -p2p
    n``, the registered (1,) mesh, kubelet's preferred allocations, no
    unsatisfiable sizes, the mock HGX node's slice and mesh grants, its
    no-ici-slice refusal and the webhook's malformed-mesh refusal, and
    the mock PCIe node's topology-unverifiable refusals and plain grant.
    (b) S and T as pods whose grant env
    comes only from their specs and the answers (``kubelet_env``, which
    also writes T's downward-API annotations file), with the
    interposer the plugin installed, under the port's monitor scanning the
    plugin's cache_host_dir: one flat leg (plugin_leg).  Each pod's env,
    region, ``mem_get_info`` and nvidia-smi samples hold its grant; T's
    switch comes on while S serves; S's tokens and T's losses are
    phase_coresidency's flat leg's.  Over that leg's monitor loop and
    sampler, NodeView serves the node's exporter, NodeTPUInfo and debug
    server through ``cmd/monitor.py``'s ``serve`` and reads them before
    S's first prefill, while S serves with T's switch on and after S's
    last launch, each time against both regions and the sampler's rows
    (``node_reading``); vgpu-smi runs under T's grant env alone and over
    the containers dir; /debug/vars and /debug/stacks answer
    (``node_view_checks``).  MIG (real_mig_checks, mig_leg,
    mig_summary): NVML's MIG mode of the card beside nvidia-smi's, the
    card's advertisement unchanged under mixed, and the mock MIG node's
    Register calls, ListAndWatch, preferred allocations, Allocate answers,
    scheduler registration and single's refusals.  (c) The runtime
    wrapper (oci_leg): a pod started from a bundle that vgpu-oci-runtime
    injected, held to its grant with the bundle's PYTHONPATH kept, and
    delete with a broken config.  Returns T's kernel launches."""
    from k8s_vgpu_scheduler_tpu_torch.accounting import UsageSampler
    from k8s_vgpu_scheduler_tpu_torch.cmd import monitor
    from k8s_vgpu_scheduler_tpu_torch.monitor import FeedbackLoop, RegionReader
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.tpulib import TorchBackend

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(0)
    torch_chip = TorchBackend().inventory().chips[0]
    [smi] = smi_rows("--query-gpu=index,uuid,name,memory.total,"
                     "memory.reserved,pci.bus_id")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(GRANT_ENV)}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        tmp = Path(tmp)
        root = tmp / "containers"
        root.mkdir()
        _kernels.install_shim(tmp / "shim")
        # (a) The node agent, alone with this idle process on the card.
        base = smi_card_mib()
        t0 = time.monotonic()
        agent = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--enforce-child",
             "node_agent"], env={**env, "PLUGIN_DIR": str(tmp)}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        life = []
        try:
            while agent.poll() is None:
                check(time.monotonic() - t0 < 120, "the node agent hung")
                life.append((time.monotonic() - t0, smi_card_mib(),
                             [r[0] for r in smi_rows(
                                 "--query-compute-apps=pid")]))
                time.sleep(NODE_AGENT_SMI_S)
            stdout, stderr = agent.communicate()
        finally:
            if agent.poll() is None:
                agent.kill()
                agent.communicate()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "enforce_node_agent.log").write_text(stdout + stderr)
        check(agent.returncode == 0, f"node agent exited {agent.returncode}"
              f": {stderr.strip()[-2000:]}")
        line = [x for x in stdout.splitlines() if x.startswith("ENFORCE ")]
        check(len(line) == 1, "the node agent printed no result")
        na = json.loads(line[0][len("ENFORCE "):])
        record["node_agent"] = dict(na, life=life, base_mib=base)
        log("chart mapping:", json.dumps(na["chart"]["mapping"]))
        log("chart leg:", json.dumps(chart_summary(na)))
        p2p = subprocess.run(["nvidia-smi", "topo", "-p2p", "n"],
                             capture_output=True, text=True, timeout=60,
                             env=smi_env())
        check(p2p.returncode == 0, f"nvidia-smi topo -p2p n failed: "
              f"{p2p.stderr.strip()}")
        na["fabric"]["smi_topo_p2p_n"] = p2p.stdout
        [card], [chip] = na["cards"], na["inventory"]
        # MIG: NVML's answer (or its refusal, recorded) beside nvidia-smi's.
        [mig_smi] = smi_rows("--query-gpu=mig.mode.current,mig.mode.pending")
        na["mig_real"]["smi"] = mig_smi
        nvml_mig = na["mig_real"]["nvml"]
        check(nvml_mig is not None or na["mig_real"]["not_supported"],
              "NVML gave no MIG answer and no refusal")
        check(nvml_mig is None or [MIG_MODE_NAMES.get(m, m) for m in
                                   nvml_mig["mode"]] == mig_smi,
              f"NVML's MIG mode {nvml_mig} against nvidia-smi's {mig_smi}")
        check(not chip["mig"], f"the card has MIG devices {chip['mig']}")
        check([card["index"], card["uuid"], card["name"],
               card["memory_total"] >> 20] == [int(smi[0]), smi[1], smi[2],
                                               int(smi[3])],
              f"NVML's card {card} against nvidia-smi's {smi}")
        check((card["pci_bus_id"] or "[N/A]").lower() == smi[5].lower(),
              f"PCI bus id {card['pci_bus_id']} against nvidia-smi's "
              f"{smi[5]}")
        check((chip["uuid"], chip["type"], card["name"]) == (
            torch_chip.uuid, torch_chip.type, props.name),
              f"NVML's card {chip} against torch's {torch_chip}")
        v2 = card["memory_v2"]
        sizes = dict(
            nvml_total=card["memory_total"], nvml_free=card["memory_free"],
            nvml_used=card["memory_used"],
            nvml_v2=v2, smi_total_mib=int(smi[3]),
            smi_reserved_mib=int(smi[4]),
            torch_total=props.total_memory,
            advertised_mib=na["advertised"][0]["devmem"])
        check(sizes["advertised_mib"] == chip["hbm_mib"]
              == props.total_memory >> 20,
              f"advertised {sizes['advertised_mib']} MiB, CUDA's "
              f"{props.total_memory >> 20} MiB")
        check(v2 is None or v2["total"] - v2["reserved"]
              == props.total_memory,
              f"v2 total less reserved {v2} against {props.total_memory}")
        check(not any(na["polls"]) and chip["healthy"],
              f"the node agent's polls {na['polls']}, healthy "
              f"{chip['healthy']}")
        check(not na["torch_loaded"], "the node agent loaded torch")
        rise = max(m for _, m, _ in life) - base if life else None
        check(len(life) >= 5 and rise <= TOL_CONTEXT_MIB,
              f"the card's memory rose {rise} MiB in the node agent's life "
              f"({len(life)} samples)")
        check(not any(str(agent.pid) in pids for _, _, pids in life),
              "the node agent is a compute process")
        check([(d["id"], d["devmem"], d["count"], d["health"])
               for d in na["registered"]]
              == [(chip["uuid"], sizes["advertised_mib"], 10, True)],
              f"the scheduler registered {na['registered']}, NVML's card "
              f"{chip['uuid']} advertised at {sizes['advertised_mib']} MiB")
        for name, pod in na["pods"].items():
            anns = pod["pod"]["metadata"]["annotations"]
            check(anns["vtpu.dev/bind-phase"] == "success"
                  and not pod["locked"],
                  f"{name}: bind phase {anns['vtpu.dev/bind-phase']}, lock "
                  f"{pod['locked']}")
            check((root / pod["key"]).is_dir(), f"{name}: no region dir")
            placed(name, pod, chip["uuid"])
        # (b) The two pods, started at once (their imports overlap); each
        # touches the card only after its go.
        volumes = tmp / "volumes"
        envs = {name: kubelet_env(pod["pod"], pod["response"], volumes)
                for name, pod in na["pods"].items()}
        check(Path(envs["train"]["VTPU_PODINFO_ANNOTATIONS"]).read_text()
              == podinfo_text(na["pods"]["train"]["pod"]["metadata"]
                              ["annotations"])
              and "VTPU_PODINFO_ANNOTATIONS" not in envs["serve"],
              "T's downward-API annotations file")
        check(all(e["LD_PRELOAD"] == str(tmp / "shim" / "libvgpu_cuda.so")
                  for e in envs.values()),
              f"LD_PRELOAD {[e['LD_PRELOAD'] for e in envs.values()]}")
        leg = tmp / "leg"
        leg.mkdir()
        children = {}
        for name, pod in na["pods"].items():
            grant = dict(envs[name])
            child = EnforceChild(
                f"cores_{name}", tmp, label=f"plugin_{name}",
                region=grant.pop("CUDA_DEVICE_MEMORY_SHARED_CACHE"),
                CORES_DIR=leg, CORES_NAME=name,
                CORES_BURSTS=CORES_BURST_S, **grant)
            child.ctl, child.name, child.key = leg, name, pod["key"]
            child.go = (lambda c: lambda: pool.submit(
                c.run, record, "device_plugin_children"))(child)
            children[name] = child
        reader = RegionReader(str(vgpu))
        loop = FeedbackLoop(str(root), reader=reader)
        sampler = UsageSampler(loop)
        stop = threading.Event()
        seen = set()
        smi_grant = {k: v for k, v in envs["train"].items()
                     if k.startswith(GRANT_ENV)
                     and k not in ("LD_PRELOAD", "PYTHONPATH")}
        view = NodeView(loop, sampler, reader, root, PLUGIN_NODE,
                        {"PATH": os.environ.get("PATH", ""), **smi_grant},
                        vgpu)

        def on_tick():
            seen.update(loop.containers)
            view.on_tick()

        ticker = threading.Thread(
            target=monitor.run, daemon=True, name="vgpu-monitor-ticker",
            args=(loop, sampler, MONITOR_INTERVAL_S, stop),
            kwargs=dict(on_tick=on_tick))
        ticker.start()
        tl = Timeline(reader, root)
        card_mib = []
        smi_stop = threading.Event()

        def sample_card():
            while not smi_stop.is_set():
                card_mib.append((time.monotonic(), smi_card_mib()))
                smi_stop.wait(SMI_EVERY_S)

        smi_thread = threading.Thread(target=sample_card, daemon=True)
        base = smi_card_mib()
        smi_thread.start()
        try:
            legs = plugin_leg(tl, children["train"], children["serve"], view)
            regions = {}
            for name, child in children.items():
                r = reader.open(str(root / child.key / "cudevshr.cache"))
                check(r is not None, f"{name}: no region")
                regions[name] = dict(limit=r.limit(0), sm_limit=r.sm_limit(0),
                                     uuid=r.uuid(0), priority=r.priority)
                r.close()
            node_view = view.debug_checks()
        finally:
            smi_stop.set()
            smi_thread.join()
            stop.set()
            ticker.join()
            view.stop()
            tl.close()
            loop.close()
            for child in children.values():
                child.stop()
        # (c) The runtime wrapper, alone on the card.
        oci = oci_leg(tmp, chip["uuid"])
    record["device_plugin_s"] = time.monotonic() - t_phase
    summary = record["device_plugin"] = plugin_checks(
        record, na, sizes, envs, regions, legs, tl, seen, card_mib, base,
        children)
    summary["node_view"] = node_view_checks(node_view, legs, children,
                                            sizes["advertised_mib"])
    summary["mig"] = mig_summary(na)
    summary["oci"] = oci
    log(json.dumps(summary))
    t = legs["train"]
    return [t["launches"][n] for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")]


# The stand-in OCI runtime oci_leg writes (the machine has no root for
# runc): it logs its argv, and on create starts the bundle's process with
# the bundle's env alone, each bind-mounted container path read as its
# host path (PYTHONPATH entry by entry) and the library the mounted
# /etc/ld.so.preload names as LD_PRELOAD, as kubelet_env reads an answer.
OCI_STANDIN = """#!{python}
import json, os, subprocess, sys
with open(os.environ["OCI_STANDIN_LOG"], "a") as f:
    f.write(json.dumps(sys.argv) + "\\n")
if "create" not in sys.argv:
    sys.exit(0)
bundle = sys.argv[sys.argv.index("--bundle") + 1]
with open(os.path.join(bundle, "config.json")) as f:
    spec = json.load(f)
mounts = {{m["destination"]: m["source"] for m in spec.get("mounts", [])
          if m.get("type") == "bind"}}
def host(path):
    for c, h in mounts.items():
        if path == c or path.startswith(c + "/"):
            return h + path[len(c):]
    return path
env = {{}}
for e in spec["process"]["env"]:
    k, v = e.split("=", 1)
    env[k] = ":".join(map(host, v.split(":"))) if k == "PYTHONPATH" else host(v)
if "/etc/ld.so.preload" in mounts:
    with open(mounts["/etc/ld.so.preload"]) as f:
        env["LD_PRELOAD"] = ":".join(host(lib) for lib in f.read().split())
sys.exit(subprocess.call(spec["process"]["args"], env=env,
                         cwd=spec["process"].get("cwd", "/")))
"""


def oci_leg(tmp: Path, uuid: str) -> dict:
    """The runtime wrapper on the card, alone on it: a bundle (the
    ``oci_pod`` child, this process's env as the image's but for any
    grant, PYTHONPATH the image's module dir) and an oci.json granting the
    card OCI_GRANT_MIB, oversubscribed, with the shim the plugin installed
    and a region dir of its own; ``vgpu-oci-runtime --root <dir> create``
    through the stand-in, which runs the pod.  The injected bundle must
    hold the grant, the mounts and PYTHONPATH = the shim dir then the
    image's; the pod is refused within TOL_GRANT_MIB of the grant by
    nvidia-smi, its region's ``used`` within TOL_USED of that reading,
    ``mem_get_info`` totals the grant, and it imported the image's module
    and nothing of the port.  Then ``delete`` with a broken oci.json must
    reach the stand-in, argv[0] forced to it, as create did."""
    root = tmp / "oci"
    bundle, image, region = root / "bundle", root / "image", root / "region"
    for d in (bundle, image, region):
        d.mkdir(parents=True)
    (image / f"{OCI_PROBE}.py").write_text("IMAGE = True\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(GRANT_ENV)}
    spec = {"ociVersion": "1.0.2", "process": {
        "args": [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--enforce-child", "oci_pod"],
        "env": [f"{k}={v}" for k, v in env.items()]
        + [f"PYTHONPATH={image}"], "cwd": str(ROOT)},
        "mounts": [{"destination": "/proc", "source": "proc",
                    "type": "proc"}]}
    (bundle / "config.json").write_text(json.dumps(spec))
    config = root / "oci.json"
    config.write_text(json.dumps({
        "chip_limits_mib": {"0": OCI_GRANT_MIB}, "visible_devices": uuid,
        "oversubscribe": True, "shim_host_dir": str(tmp / "shim"),
        "cache_host_dir": str(region)}))
    standin, log_path = root / "runtime", root / "runtime.log"
    standin.write_text(OCI_STANDIN.format(python=sys.executable))
    standin.chmod(0o755)
    wrapper_env = dict(env, VTPU_OCI_RUNTIME=str(standin),
                       VTPU_OCI_CONFIG=str(config),
                       OCI_STANDIN_LOG=str(log_path))
    state = str(root / "state")
    wrapper = [sys.executable, "-m",
               "k8s_vgpu_scheduler_tpu_torch.cmd.oci_runtime", "--root",
               state]
    t0 = time.monotonic()
    res = subprocess.run(wrapper + ["create", "--bundle", str(bundle),
                                    "oci-pod"], env=wrapper_env, cwd=ROOT,
                         input="go\n", capture_output=True, text=True,
                         timeout=300)
    create_s = time.monotonic() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "enforce_oci_pod.log").write_text(res.stdout + res.stderr)
    check(res.returncode == 0, f"vgpu-oci-runtime create exited "
          f"{res.returncode}: {res.stderr.strip()[-2000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("ENFORCE ")]
    check(len(line) == 1, "the OCI pod printed no result")
    pod = json.loads(line[0][len("ENFORCE "):])
    injected = json.loads((bundle / "config.json").read_text())
    envs = dict(e.split("=", 1) for e in injected["process"]["env"])
    grant = {k: v for k, v in envs.items() if k.startswith(GRANT_ENV)}
    mounts = sorted((m["destination"], m["source"], m.get("options"))
                    for m in injected["mounts"])
    shim = tmp / "shim"
    check(grant == {"CUDA_DEVICE_MEMORY_LIMIT_0": str(OCI_GRANT_MIB),
                    "NVIDIA_VISIBLE_DEVICES": uuid,
                    "CUDA_OVERSUBSCRIBE": "true",
                    "CUDA_DEVICE_MEMORY_SHARED_CACHE":
                        "/tmp/vgpu/cudevshr.cache",
                    "PYTHONPATH": f"/usr/local/vgpu:{image}"}
          and mounts == sorted([
              ("/proc", "proc", None),
              ("/usr/local/vgpu", str(shim), ["rbind", "ro"]),
              ("/etc/ld.so.preload", str(shim / "ld.so.preload"),
               ["rbind", "ro"]),
              ("/tmp/vgpu", str(region), ["rbind", "rw"])]),
          f"the injected bundle: {grant}, {mounts}")
    smi = pod["smi_used_mib_at_refusal"]
    check_grant(smi, OCI_GRANT_MIB, "the OCI pod")
    check(abs(pod["region_used_at_refusal"] - smi * MIB)
          <= TOL_USED * smi * MIB,
          f"the OCI pod's region used {pod['region_used_at_refusal']} "
          f"against nvidia-smi's {smi} MiB")
    check(pod["mem_get_info_total"] == OCI_GRANT_MIB * MIB,
          f"the OCI pod's mem_get_info total {pod['mem_get_info_total']}")
    check(pod["pythonpath"] == f"{shim}:{image}"
          and pod["probe"] == str(image / f"{OCI_PROBE}.py")
          and pod["hook"] == str(shim / "sitecustomize.py")
          and pod["ld_preload"] == str(shim / "libvgpu_cuda.so"),
          f"the OCI pod's PYTHONPATH {pod['pythonpath']}, module "
          f"{pod['probe']}, hook {pod['hook']}, LD_PRELOAD "
          f"{pod['ld_preload']}")
    config.write_text("{not json")
    t0 = time.monotonic()
    res = subprocess.run(wrapper + ["delete", "oci-pod"], env=wrapper_env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    delete_s = time.monotonic() - t0
    check(res.returncode == 0, f"vgpu-oci-runtime delete with a broken "
          f"config exited {res.returncode}: {res.stderr.strip()[-2000:]}")
    argvs = [json.loads(x) for x in log_path.read_text().splitlines()]
    check(argvs == [[str(standin), "--root", state, "create", "--bundle",
                     str(bundle), "oci-pod"],
                    [str(standin), "--root", state, "delete", "oci-pod"]],
          f"the runtime was called with {argvs}")
    return dict(create_s=create_s, delete_s=delete_s, grant=grant,
                runtime_argvs=len(argvs),
                pod={k: pod[k] for k in (
                    "mem_get_info_total", "blocks_before_refusal",
                    "smi_used_mib_at_refusal", "smi_baseline_mib",
                    "region_used_at_refusal", "pythonpath", "run_s")})


def fabric_summary(na: dict) -> dict:
    """The node agent's fabric record (checked in the child by
    fabric_checks and hgx_leg), cut to what the phase's line prints:
    NVML's answers and nvidia-smi's P2P matrix, the registered topology,
    kubelet's answers, the annotation, and the mock nodes' registrations,
    grants, reasons and times."""
    fabric, hgx = na["fabric"], na["hgx"]
    pods = hgx["pods"]
    return {
        "p2p": fabric["p2p"], "p2p_self": fabric["p2p_self"],
        "smi_topo_p2p_n": fabric.get("smi_topo_p2p_n"),
        "registered": fabric["registered"],
        "options_s": fabric["options_s"], "preferred": fabric["preferred"],
        "unsatisfiable": fabric["unsatisfiable"],
        "hgx": {
            "register_s": hgx["register_s"],
            "registered": hgx["registered"]["topology"],
            "agent_fabric": {k: hgx["agent"]["fabric"][k]
                             for k in ("kind", "not_supported")},
            "bad_mesh": hgx["bad_mesh"],
            "pcie_registered": {k: hgx["pcie_registered"][k]
                                for k in ("register_s", "topology",
                                          "coords")},
            "pcie_agent_fabric": hgx["pcie_agent"]["fabric"]["kind"],
            "known_topologies": hgx["known_topologies"],
            **{name: {
                "cards": rec.get("cards"),
                "failed": rec["filter"]["FailedNodes"],
                **{k: rec[k] for k in ("webhook_s", "filter_s", "bind_s")
                   if k in rec}} for name, rec in pods.items()}},
    }


def chart_summary(na: dict) -> dict:
    """The chart leg's record as the phase's line prints it (checked in
    chart_leg): how it rendered and mapped TLS, the seconds to the
    agent's registration and to kubelet's, the webhook's and Filter's
    seconds, each daemon's seconds from SIGTERM to its end, the families
    the dashboards name and the two scrapes held, and the leg's seconds."""
    c = na["chart"]
    return {k: c[k] for k in ("render", "tls", "register_s",
                              "kubelet_register_s", "webhook_s", "filter_s",
                              "stop_s", "families", "leg_s")}


def mig_summary(na: dict) -> dict:
    """The MIG record of the phase's line (checked in node_agent and the
    phase): the real card's NVML and nvidia-smi answers, and the mock MIG
    node's registrations, answers, refusals and times."""
    real, mig = na["mig_real"], na["mig"]
    return {
        "real": {k: real.get(k) for k in ("nvml", "not_supported", "smi",
                                          "list_and_watch_devices",
                                          "seconds")},
        "kubelet_register_s": mig["kubelet_register_s"],
        "registered": mig["registered"],
        "scheduler_register_s": mig["scheduler"]["register_s"],
        "list_and_watch": {r: [len(v["ids"]), v["seconds"]]
                           for r, v in mig["list_and_watch"].items()},
        "whole_pod_failed": mig["whole_pod"]["filter"]["FailedNodes"],
        "preferred": [[p["ids"], p["seconds"]] for p in mig["preferred"]],
        "allocate": {k: mig["allocate"][k] for k in ("id", "envs",
                                                     "seconds")},
        "unknown": mig["unknown"], "refusals": mig["refusals"],
        "run_s": mig["run_s"]}


def placed(name: str, pod: dict, uuid: str, cores=CORES_SM_LIMIT) -> None:
    """Checks of one pod that the port's control plane placed: the
    webhook's env and scheduler name in its spec, Filter's node, and the
    grant Filter wrote (the card's UUID, the pod's MiB and ``cores``) as
    what Allocate took."""
    from k8s_vgpu_scheduler_tpu_torch.util import codec

    spec = pod["pod"]["spec"]
    env = {e["name"]: e["value"] for e in spec["containers"][0]["env"]}
    check(env.get("CUDA_TASK_PRIORITY") == str(pod["priority"])
          and spec.get("schedulerName") == "vgpu-scheduler"
          and spec.get("nodeName") == PLUGIN_NODE,
          f"{name}: the webhook's spec {spec}")
    anns = pod["pod"]["metadata"]["annotations"]
    [[grant]] = codec.decode_pod_devices(anns["vtpu.dev/assigned-ids"])
    check(anns["vtpu.dev/assigned-node"] == PLUGIN_NODE
          and (grant.uuid, grant.usedmem, grant.usedcores)
          == (uuid, pod["grant_mib"], cores)
          and pod["handshake"]["filter"]["NodeNames"] == [PLUGIN_NODE],
          f"{name}: Filter's grant {grant} on "
          f"{anns['vtpu.dev/assigned-node']}")
    check(pod["response"]["envs"]["CUDA_DEVICE_MEMORY_LIMIT_0"]
          == str(pod["grant_mib"])
          and pod["response"]["envs"]["NVIDIA_VISIBLE_DEVICES"] == uuid,
          f"{name}: Allocate's answer {pod['response']['envs']}")


def plugin_leg(tl: Timeline, t, s, view=None) -> dict:
    """phase_coresidency's flat leg, shortened: T alone for CORES_SOLO_S;
    S loads and warms up; once T's switch has fallen, S's one burst; T
    alone for CORES_TAIL_S; both exit, and the monitor must clear their
    slots.  Each pod's life on the host clock goes with its reading.
    ``view`` (a NodeView) reads the node's surfaces before S's first
    prefill, while S serves with T's switch on, and after S's last launch,
    where vgpu-smi also runs (``NodeView.smi``)."""
    keys = (t.key, s.key)
    t_go = time.monotonic()
    ft = t.go()
    await_file(t.ctl / "train_ready", [ft], "T ready (device plugin)")
    time.sleep(CORES_SOLO_S)
    s_go = time.monotonic()
    fs = s.go()
    await_file(s.ctl / f"{s.name}_ready", [ft, fs],
               "S ready (device plugin)", limit=600)
    await_switch(tl, t.key, 0, time.monotonic(), "T after S's loading")
    time.sleep(MONITOR_INTERVAL_S)
    if view is not None:
        view.read("before_prefill", keys)
    (s.ctl / f"{s.name}_go").touch()
    if view is not None:
        await_switch(tl, t.key, 1, time.monotonic(), "T while S serves")
        view.read("switch_on", keys)
    serve = dict(fs.result(), life=(s_go, time.monotonic()))
    tail = time.monotonic()
    if view is not None:
        view.read("after_last_launch", keys)
        view.smi(t.key, keys)
    time.sleep(max(0.0, CORES_TAIL_S - (time.monotonic() - tail)))
    (t.ctl / "train_stop").touch()
    trainer = dict(ft.result(), life=(t_go, time.monotonic()))
    await_gc(tl, keys, "device plugin leg")
    return {"train": trainer, "serve": serve}


class NodeView:
    """Leg (a) of the node's observability: over phase_device_plugin's
    monitor loop and sampler, the exporter, NodeTPUInfo (loopback) and the
    debug server, started through ``cmd/monitor.py``'s ``serve`` with
    NVML's inventory (``detect()``); the ticker's ``on_tick`` is
    :meth:`on_tick`.  :meth:`read` takes one reading: right after a tick,
    each pod's region, the sampler's rows, a scrape and a GetNodeTPU call,
    then the regions and rows again, until no tick fell between (at most
    5 tries), held together by ``node_reading``."""

    def __init__(self, loop, sampler, reader, root: Path, node: str,
                 smi_env: dict, vgpu: Path) -> None:
        import grpc

        from k8s_vgpu_scheduler_tpu_torch.cmd import monitor
        from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import node_tpu_stub
        from k8s_vgpu_scheduler_tpu_torch.tpulib import detect
        from k8s_vgpu_scheduler_tpu_torch.util import trace

        self.loop, self.sampler, self.reader = loop, sampler, reader
        self.root, self.node = root, node
        self.smi_env, self.vgpu = smi_env, vgpu
        snap = trace.tracer().histogram_snapshot().get(("region-scan", ""))
        self.scans0 = snap[1] if snap else 0
        self.ticks = 0
        self.ticked = threading.Event()
        self.readings: dict = {}
        self.backend = detect()
        self.advertised = {c.uuid: c.hbm_mib
                           for c in self.backend.inventory().chips}
        try:
            t0 = time.monotonic()
            self.serving = monitor.serve(
                loop, sampler, self.backend, node, metrics_port=0,
                grpc_port=free_port(), debug_port=free_port(),
                metrics_host="127.0.0.1")
            self.serve_s = time.monotonic() - t0
        except BaseException:
            self.close_backend()
            raise
        self.url = f"http://127.0.0.1:{self.serving.metrics.port}/metrics"
        self.debug = f"http://127.0.0.1:{self.serving.debug.port}"
        self.channel = grpc.insecure_channel(
            f"127.0.0.1:{self.serving.rpc_port}")
        self.stub = node_tpu_stub(self.channel)

    def on_tick(self) -> None:
        self.ticks += 1
        self.ticked.set()

    def regions(self, keys) -> dict:
        out = {}
        for key in keys:
            r = self.reader.open(str(self.root / key / "cudevshr.cache"))
            check(r is not None, f"{key}: no region")
            try:
                out[key] = region_reading(r)
            finally:
                r.close()
        return out

    def rows(self, keys) -> dict:
        return {row["ctrkey"]: row for row in self.sampler.snapshot()
                if row["ctrkey"] in keys}

    def read(self, label: str, keys) -> dict:
        from k8s_vgpu_scheduler_tpu_torch.api import noderpc_pb2 as npb

        def steady(r):
            return {k: dict(v, used=None) for k, v in r.items()}

        for _ in range(5):
            self.ticked.clear()
            check(self.ticked.wait(10 * MONITOR_INTERVAL_S),
                  f"{label}: no monitor tick")
            n, before, rows = self.ticks, self.regions(keys), self.rows(keys)
            metrics, scrape_s, nbytes, families = scrape(self.url)
            t0 = time.monotonic()
            reply = self.stub(npb.GetNodeTPURequest(), timeout=30)
            rpc_s = time.monotonic() - t0
            after = self.regions(keys)
            if self.ticks == n and steady(before) == steady(after) \
                    and rows == self.rows(keys):
                break
        else:
            check(False, f"{label}: a monitor tick fell in every reading")
        pods = node_reading(metrics, rpc_usages(reply), {
            k: dict(before[k], used=after[k]["used"]) for k in keys}, rows,
            self.scans0 + n, self.advertised, self.node)
        self.readings[label] = dict(
            at=time.monotonic(), scrape_s=scrape_s, scrape_bytes=nbytes,
            families=families,
            samples=sum(len(v) for v in metrics.values()),
            get_node_tpu_s=rpc_s, pods=pods)
        log(f"node view {label}: " + json.dumps(self.readings[label]))
        return self.readings[label]

    def smi(self, key: str, keys) -> None:
        """vgpu-smi --json under T's grant env alone (no LD_PRELOAD: the
        interposer would join the process to T's region), and
        vgpu-smi --containers-dir over the monitor's root."""
        def run(args, env):
            t0 = time.monotonic()
            res = subprocess.run(
                [sys.executable, "-m", "k8s_vgpu_scheduler_tpu_torch.cmd."
                 "vgpu_smi", "--json", "--library", str(self.vgpu), *args],
                env=env, cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            check(res.returncode == 0, f"vgpu-smi {args} exited "
                  f"{res.returncode}: {res.stderr.strip()[-2000:]}")
            return json.loads(res.stdout), time.monotonic() - t0

        with ThreadPoolExecutor(2) as pool:
            before = self.regions([key])[key]
            inside = pool.submit(run, [], self.smi_env)
            node = pool.submit(run, ["--containers-dir", str(self.root)],
                               {"PATH": os.environ.get("PATH", "")})
            (got, inside_s), (listed, node_s) = inside.result(), \
                node.result()
        after = self.regions([key])[key]
        [dev] = got["this container"]["devices"]
        check(dev["memory_total_mib"] == before["limit"] // MIB
              and dev["core_limit_pct"] == before["sm_limit"]
              and dev["memory_used_mib"] in (before["used"] // MIB,
                                             after["used"] // MIB),
              f"vgpu-smi under T's grant reads {dev}, T's region "
              f"{before} then {after}")
        check(set(keys) <= set(listed), f"vgpu-smi --containers-dir lists "
              f"{sorted(listed)}")
        self.readings["smi"] = dict(device=dev, inside_s=inside_s,
                                    containers_dir_s=node_s,
                                    listed=sorted(listed))
        log("vgpu-smi: " + json.dumps(self.readings["smi"]))

    def debug_checks(self) -> dict:
        """/debug/vars gives this process's pid and /debug/stacks shows
        the ticker thread: the readings."""
        status, vars_ = http(f"{self.debug}/debug/vars", timeout=30)
        check(status == 200 and vars_["pid"] == os.getpid(),
              f"/debug/vars answered {status} {vars_}")
        status, stacks = http(f"{self.debug}/debug/stacks", timeout=30)
        check(status == 200 and "vgpu-monitor-ticker" in stacks,
              "/debug/stacks shows no ticker thread")
        return dict(self.readings, serve_s=self.serve_s,
                    advertised=self.advertised)

    def close_backend(self) -> None:
        close = getattr(self.backend, "close", None)  # NVML's shutdown
        if close is not None:
            close()

    def stop(self) -> None:
        if self.channel is not None:
            self.channel.close()
            self.channel = None
            self.serving.stop()
            self.close_backend()


def node_view_checks(view: dict, legs: dict, children: dict,
                     advertised_mib: int) -> dict:
    """Leg (a) across its readings: T's switch 0 before S's first prefill
    and 1 while S serves (the reading inside S's burst), S's 0 at every
    reading; the summary."""
    T, S = children["train"].key, children["serve"].key
    order = ("before_prefill", "switch_on", "after_last_launch")
    switch = {k: [view[r]["pods"][k]["switch"] for r in order]
              for k in (T, S)}
    check(switch[T][:2] == [0, 1] and switch[S] == [0, 0, 0],
          f"the switches at the readings {switch}")
    b = legs["serve"]["bursts"][0]
    at = view["switch_on"]["at"]
    check(b["start"] <= at <= b["end"], f"the switch-on reading at {at} "
          f"fell outside S's burst {b['start']}..{b['end']}")
    check(list(view["advertised"].values()) == [advertised_mib],
          f"the exporter's inventory {view['advertised']}, the card "
          f"advertised at {advertised_mib} MiB")
    dev = view["smi"]["device"]
    check(dev["memory_total_mib"] == legs["train"]["mem_total"] // MIB
          and dev["core_limit_pct"] == CORES_SM_LIMIT,
          f"vgpu-smi under T's grant reads {dev}, T's grant "
          f"{legs['train']['mem_total'] // MIB} MiB at {CORES_SM_LIMIT}%")
    return dict(view, switch=switch, advertised_mib=advertised_mib)


def scrape(url: str) -> tuple:
    """GET a Prometheus exporter through the port's own parser
    (``vgpu_smi.parse_prom``): (metrics, seconds, bytes, families)."""
    import urllib.request

    from k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_smi import parse_prom

    t0 = time.monotonic()
    with urllib.request.urlopen(url, timeout=30) as r:
        check(r.status == 200, f"{url} answered {r.status}")
        text = r.read().decode()
    seconds = time.monotonic() - t0
    families = sum(1 for line in text.splitlines()
                   if line.startswith("# TYPE "))
    return parse_prom(text), seconds, len(text.encode()), families


def metric(metrics: dict, name: str, **labels):
    """The value of ``name``'s one sample whose labels include ``labels``
    (in ``parse_prom``'s form), or None; two such samples fail."""
    hits = [v for got, v in metrics.get(name, [])
            if all(got.get(k) == x for k, x in labels.items())]
    check(len(hits) <= 1, f"{name}{labels}: {len(hits)} samples")
    return hits[0] if hits else None


def region_reading(r) -> dict:
    """A region's fields as the node's surfaces report them (device 0)."""
    return dict(uuid=r.uuid(0) or "0", limit=r.limit(0),
                sm_limit=r.sm_limit(0), used=r.used(0),
                procs=len(r.proc_pids()), oversubscribe=r.oversubscribe,
                switch=r.utilization_switch)


def rpc_usages(reply) -> dict:
    """A GetNodeTPU reply's regions in ``region_reading``'s form."""
    return {u.ctrkey: dict(uuid=u.info.uuids[0], limit=u.info.limit[0],
                           sm_limit=u.info.sm_limit[0], used=u.info.used[0],
                           procs=len(u.info.procs),
                           oversubscribe=u.info.oversubscribe,
                           switch=u.info.utilization_switch)
            for u in reply.usages}


def within(got, want, rel: float) -> bool:
    return got is not None and abs(got - want) <= rel * abs(want)


def node_reading(metrics: dict, rpc: dict, direct: dict, rows: dict,
                 scans: int, advertised: dict, node: str) -> dict:
    """Leg (a)'s checks at one reading of the node exporter (``metrics``,
    parsed) and NodeTPUInfo (``rpc``, ``rpc_usages``) against each
    region read at once (``direct``: key -> ``region_reading``, its
    ``used`` read just after) and the sampler's rows (key -> row): limit,
    core cap, processes, oversubscription and switch equal; used within 1%
    on both surfaces; the usage counters equal the rows'; each card's
    ``host_tpu_memory_total_mib`` its advertised MiB (``advertised``: uuid
    -> MiB); ``region-scan`` counted ``scans`` times."""
    out = {}
    for key, d in direct.items():
        dev = dict(container=key, deviceuuid=d["uuid"])
        got = dict(
            limit=metric(metrics, "vtpu_device_memory_limit_bytes", **dev),
            sm_limit=metric(metrics, "vtpu_device_core_limit_percent", **dev),
            procs=metric(metrics, "vtpu_container_processes", container=key),
            oversubscribe=metric(metrics, "vtpu_oversubscribe",
                                 container=key),
            switch=metric(metrics, "vtpu_utilization_switch", container=key))
        want = {k: d[k] for k in got}
        check(got == want, f"{key}: the exporter reads {got}, the region "
              f"{want}")
        r = rpc.get(key)
        check(r is not None and {k: r[k] for k in (*want, "uuid")}
              == {**want, "uuid": d["uuid"]},
              f"{key}: NodeTPUInfo reads {r}, the region {d}")
        used = metric(metrics, "vtpu_device_memory_usage_bytes", **dev)
        check(within(used, d["used"], 0.01) and within(r["used"], d["used"],
                                                       0.01),
              f"{key}: used {used} (exporter), {r['used']} (NodeTPUInfo), "
              f"{d['used']} (region)")
        row = rows[key]
        for field in ("chip_seconds", "throttled_seconds"):
            m = metric(metrics, f"vtpu_usage_{field}_total", container=key)
            check(m == row[field], f"{key}: vtpu_usage_{field} {m}, the "
                  f"sampler's {row[field]}")
        out[key] = dict(switch=d["switch"], procs=d["procs"],
                        used=d["used"], exporter_used=used, rpc_used=r["used"],
                        chip_seconds=row["chip_seconds"],
                        throttled_seconds=row["throttled_seconds"])
    for uuid, mib in advertised.items():
        got = metric(metrics, "host_tpu_memory_total_mib", node=node,
                     deviceuuid=uuid)
        check(got == mib, f"host_tpu_memory_total_mib {got}, advertised "
              f"{mib}")
    got = metric(metrics, "vtpu_monitor_phase_latency_seconds_count",
                 phase="region-scan", qos="")
    check(got == scans, f"region-scan counted {got} times, {scans} ticks")
    return out


def efficiency_skew_bound(covered_s: float) -> float:
    """The most a pod's efficiency on /usagez can read (ROADMAP C.9).  The
    join divides GPU-seconds counted on the monitor's clock by a window on
    the ledger's: the window runs from the ledger's first record of the
    pod to its last, but the first record's counts were sampled up to one
    register beat and one monitor tick before it, and the two loops jitter
    by up to a tick more.  So a pod that launches for its whole window
    reads up to ``1 + (beat + 2 ticks) / window``, above 1."""
    return 1 + (REGISTER_BEAT_S + 2 * MONITOR_INTERVAL_S) / covered_s


def ledger_vs_monitor(ext: dict, mon: dict, pods: dict) -> dict:
    """Leg (b): each pod's ledger totals on the extender's exporter
    (``ext``) against the counters on the monitor's own (``mon``) for the
    same container key (``pods``: key -> (namespace, name)), to a relative
    1e-9, each above 0."""
    out = {}
    for key, (namespace, name) in pods.items():
        row = {}
        for field in ("chip_seconds", "hbm_byte_seconds"):
            m = metric(mon, f"vtpu_usage_{field}_total", container=key)
            e = metric(ext, f"vtpu_usage_{field}_total",
                       podnamespace=namespace, podname=name)
            check(m is not None and m > 0 and within(e, m, 1e-9),
                  f"{key}: {field} {e} in the ledger, {m} on the monitor")
            row[field] = e
        out[key] = row
    return out


def plugin_checks(record, na, sizes, envs, regions, legs, tl, seen,
                  card_mib, base, children) -> dict:
    """(b)'s checks and the phase's summary line."""
    pods = na["pods"]
    uuid = na["cards"][0]["uuid"]
    for name, run in legs.items():
        pod = pods[name]
        grant = pod["grant_mib"] * MIB
        check(run["grant_env"] == envs[name],
              f"{name}: the pod's grant env {run['grant_env']} is not what "
              f"the answer and its spec give: {envs[name]}")
        want = dict(limit=grant, sm_limit=CORES_SM_LIMIT, uuid=uuid,
                    priority=pod["priority"])
        check(regions[name] == want,
              f"{name}: region {regions[name]}, grant {want}")
        check(run["mem_total"] == grant,
              f"{name}: mem_get_info total {run['mem_total']}, grant {grant}")
    # nvidia-smi lists every process of this machine under one pid, so
    # the card's reading less this process's is held to the grants of the
    # pods alive at the sample (S's memory may take RETURN_S to come back
    # after it exits).
    t_life = legs["train"]["life"]
    s_life = (legs["serve"]["life"][0], legs["serve"]["life"][1] + RETURN_S)
    worst = {}
    for at, mib in card_mib:
        alive = [n for n, (a, b) in (("train", t_life), ("serve", s_life))
                 if a <= at <= b]
        if not alive:
            continue
        key = "+".join(alive)
        allowed = sum(pods[n]["grant_mib"] for n in alive)
        check(mib - base <= allowed, f"{key}: {mib - base} MiB on the card "
              f"past the grants' {allowed} MiB")
        worst[key] = max(worst.get(key, 0), mib - base)
    check({"train", "train+serve"} <= set(worst),
          f"no nvidia-smi sample with T alone and with both: {worst}")
    T, S = children["train"].key, children["serve"].key
    check({T, S} <= seen, f"the monitor saw {sorted(seen)}")
    b = legs["serve"]["bursts"][0]
    on = tl.first(T, b["start"], SWITCH, 1)
    check(on <= b["end"], "T's switch never came on while S served")
    flat = record["coresidency_children"]
    check(legs["serve"]["tokens"] == flat["uidF_serve"]["tokens"],
          "S's tokens differ from phase_coresidency's")
    ref = flat["uidF_train"]["losses"]
    n = min(len(ref), len(legs["train"]["losses"]))
    check(n >= 4 and legs["train"]["losses"][:n] == ref[:n],
          f"T's losses {legs['train']['losses'][:n]} differ from "
          f"phase_coresidency's {ref[:n]}")
    return {
        "phase": "device_plugin", "card": record["card"],
        "seconds": record["device_plugin_s"],
        "nvml": {k: na["cards"][0][k] for k in (
            "index", "uuid", "name", "serial", "pci_bus_id", "minor",
            "not_supported")},
        "memory": sizes,
        "events": {"registered": na["events_registered"],
                   "unsupported": na["events_unsupported"],
                   "error": na["events_error"]},
        "packages": na["packages"],
        "node_agent": {
            "run_s": na["run_s"],
            "samples": len(record["node_agent"]["life"]),
            "card_mib_rise_max": max(
                (m for _, m, _ in record["node_agent"]["life"]),
                default=0) - record["node_agent"]["base_mib"],
            "torch_loaded": na["torch_loaded"], "polls": na["polls"]},
        "fabric": fabric_summary(na),
        "chart": chart_summary(na),
        "control_plane": {
            "register_s": na["register_s"], "registered": na["registered"],
            **{name: {k: pods[name]["handshake"][k] for k in (
                "patch", "webhook_s", "filter", "filter_s", "bind",
                "bind_s", "allocate_s")} for name in pods}},
        "pods": {name: {
            "grant_mib": pods[name]["grant_mib"],
            "envs": pods[name]["response"]["envs"],
            "region": regions[name], "mem_total": legs[name]["mem_total"],
            "losses" if name == "train" else "waves":
                len(legs[name]["losses"]) if name == "train"
                else len(legs[name]["bursts"][0]["waves"])}
            for name in legs},
        "card_mib_max_over_base": worst,
        "switch_on_after_first_prefill_s": on - b["start"],
    }


def same_checkpoints(torch, a: Path, b: Path) -> dict:
    """Two train-state checkpoints, mapped from disk, tensor for tensor:
    the master copy, mu, nu, the counts and the step."""
    x = torch.load(a, map_location="cpu", mmap=True, weights_only=True)
    y = torch.load(b, map_location="cpu", mmap=True, weights_only=True)
    ox, oy = x["opt_state"], y["opt_state"]
    pairs = {"params": (x["params"], y["params"]),
             "mu": (ox["mu"], oy["mu"]), "nu": (ox["nu"], oy["nu"]),
             "acc": (ox["acc"], oy["acc"])}
    equal = {k: len(u) == len(v) and all(
        torch.equal(s, t) for s, t in zip(u, v))
        for k, (u, v) in pairs.items()}
    equal.update(count=ox["count"] == oy["count"],
                 mini_step=ox["mini_step"] == oy["mini_step"],
                 step=x["step"] == y["step"])
    return dict(equal=equal, tensors=len(x["params"]) * 3,
                bytes=os.path.getsize(a))


def fleetz_checks(export: dict, ready: dict, held: dict) -> dict:
    """The extender's ``GET /fleetz`` (``export``) against the card its
    node agent registered from NVML (``ready``: the control-plane child's
    ready line; the phase registers no other node) and the grants the
    extender holds, each read from its pod's decision annotations
    (``held``: uid -> the pod as the apiserver holds it).  Returns the
    card's granted MiB with what was compared."""
    from k8s_vgpu_scheduler_tpu_torch.util import codec

    nodes = [[n["name"], n["mesh"], [[c["id"], c["devmem"], c["coords"]]
                                     for c in n["chips"]]]
             for n in export["nodes"]]
    want_nodes = [[PLUGIN_NODE, [1], [[ready["uuid"], ready["hbm_mib"],
                                       [0]]]]]
    check(nodes == want_nodes,
          f"/fleetz's nodes {nodes}, the card registered {want_nodes}")
    want = {uid: [[[d.uuid, d.usedmem] for d in ctr]
                  for ctr in codec.decode_pod_devices(
                      pod["metadata"]["annotations"]["vtpu.dev/assigned-ids"])]
            for uid, pod in held.items()}
    got = {p["uid"]: [[[d["uuid"], d["usedmem"]] for d in ctr]
                      for ctr in p["devices"]] for p in export["pods"]}
    check(got == want, f"/fleetz's grants {got}, the pods' decisions {want}")
    granted = sum(mib for ctrs in want.values() for ctr in ctrs
                  for uuid, mib in ctr if uuid == ready["uuid"])
    return dict(nodes=nodes, grants=got, granted_mib=granted,
                config=export["config"])


def simulate_live_checks(fit: dict, over: dict, ready: dict,
                         granted: int, pods: int) -> dict:
    """``vgpu-simulate --from-cluster``'s two replays of the live fleet:
    one pod of the card's remaining MiB must fit on the card and fill it;
    one of a MiB more must pend with Filter's own reason, the card's usage
    in the replay the extender's granted MiB (``pods`` grants)."""
    from k8s_vgpu_scheduler_tpu_torch.scheduler.core import NO_FIT

    card, hbm = f"{PLUGIN_NODE}/{ready['uuid']}", ready["hbm_mib"]
    left = hbm - granted
    got = [[p["pod"], p["node"], p["chips"]] for p in fit["placed"]]
    check(fit["fits"] and got == [["fit-0", PLUGIN_NODE, [{
        "uuid": ready["uuid"], "mem_mib": left, "cores": 0}]]]
          and fit["chips"][card]["mem_mib"] == [hbm, hbm]
          and fit["fleet"]["existing_pods"] == pods,
          f"the pod of the remaining {left} MiB: placed {got}, the card "
          f"{fit['chips'].get(card)}, pending {fit['pending']}")
    check(not over["fits"] and not over["placed"]
          and over["pending"] == [{"pod": "over-0", "reason": NO_FIT}]
          and over["chips"][card]["mem_mib"] == [granted, hbm],
          f"the pod of {left + 1} MiB: pending {over['pending']}, placed "
          f"{over['placed']}, the card {over['chips'].get(card)} (granted "
          f"{granted})")
    return dict(remaining_mib=left, card_mib=over["chips"][card]["mem_mib"],
                reason=over["pending"][0]["reason"])


def simulate_scale_checks(result: dict, workload: dict) -> dict:
    """The scale leg's replay of ``workload``: no card overbooked, every
    pod placed or pending, the metering within 5%, and the idle grants
    exactly the pods whose duty is 0."""
    total = sum(int(e.get("count", 1)) for e in workload["pods"])
    idle = sorted(f"{e['name']}-{i}" for e in workload["pods"]
                  if float(e.get("duty", 1.0)) == 0.0
                  for i in range(int(e.get("count", 1))))
    over = sorted(k for k, c in result["chips"].items()
                  if c["mem_mib"][0] > c["mem_mib"][1]
                  or c["cores_pct"] > 100)
    placed, pending = len(result["placed"]), len(result["pending"])
    acct = result["accounting"]
    check(not over and placed + pending == total,
          f"overbooked {over}; {placed} placed + {pending} pending of "
          f"{total}")
    check(acct["metering_ok"] and acct["max_error_pct"] <= 5.0,
          f"metering: ok {acct['metering_ok']}, max error "
          f"{acct['max_error_pct']}%")
    check(acct["idle_grants"] == idle,
          f"idle grants {acct['idle_grants']}, the idle pods {idle}")
    return dict(cards=len(result["chips"]), placed=placed, pending=pending,
                reasons=sorted({p["reason"] for p in result["pending"]}),
                hbm_allocated_fraction=result["hbm_allocated_fraction"],
                max_error_pct=acct["max_error_pct"], idle_grants=len(idle),
                fleet_efficiency=acct["fleet_efficiency"])


class FleetView:
    """Leg (b) of the observability surface: ``vgpu-monitor`` itself, as a
    process through its module, over phase_preempt's containers dir (the
    placed pods' regions; R's stays outside it), ticking every
    MONITOR_INTERVAL_S with loopback metrics, NodeTPUInfo and debug ports
    (``grpc``: the endpoint the control plane's ``--usage-from`` reads).
    Its log goes to chiprun_out/vgpu_monitor.log.  The capacity
    simulator's scale leg (``vgpu-simulate`` on SIM_FLEET at SIM_SCALE)
    starts with it, so that its CPU time runs beside the phase's pods;
    ``read`` joins it (stderr in chiprun_out/vgpu_simulate.log)."""

    def __init__(self, root: Path, vgpu: Path, env: dict) -> None:
        self.root = root
        self.sim, self.sim_files = None, []
        ports = [free_port() for _ in range(3)]
        self.url = f"http://127.0.0.1:{ports[0]}/metrics"
        self.grpc = f"127.0.0.1:{ports[1]}"
        self.debug = f"http://127.0.0.1:{ports[2]}"
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        self.log = open(out / "vgpu_monitor.log", "w")
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_vgpu_scheduler_tpu_torch.cmd.monitor",
             "--container-root", str(root), "--interval",
             str(MONITOR_INTERVAL_S), "--metrics-port", str(ports[0]),
             "--grpc-port", str(ports[1]), "--grpc-bind", "127.0.0.1",
             "--debug-port", str(ports[2]), "--node-name", PLUGIN_NODE,
             "--library", str(vgpu)], env=env, cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT)
        try:
            while True:
                check(self.proc.poll() is None, f"vgpu-monitor exited "
                      f"{self.proc.returncode} (chiprun_out/vgpu_monitor.log)")
                check(time.monotonic() - t0 < 60,
                      "vgpu-monitor served no /metrics in 60 s")
                try:
                    scrape(self.url)
                    break
                except OSError:
                    time.sleep(0.1)
            self.up_s = time.monotonic() - t0
            self.sim_json = root.parent / "vgpu_simulate_fleet.json"
            self.sim_files = [open(self.sim_json, "w"),
                              open(out / "vgpu_simulate.log", "w")]
            self.sim_t0, self.sim_s = time.monotonic(), None
            self.sim = subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_vgpu_scheduler_tpu_torch.cmd.simulate", "--workload",
                 str(SIM_FLEET), *SIM_SCALE, "--json"], env=env, cwd=ROOT,
                stdout=self.sim_files[0], stderr=self.sim_files[1])
            self.sim_waiter = threading.Thread(target=self._sim_wait,
                                               daemon=True)
            self.sim_waiter.start()
        except BaseException:
            self.stop()
            raise

    def _sim_wait(self) -> None:
        self.sim.wait()
        self.sim_s = time.monotonic() - self.sim_t0

    def scale_leg(self) -> dict:
        """The scale leg's result, once its process has ended: its
        checks, its own seconds and the seconds ``read`` waited for it."""
        t0 = time.monotonic()
        self.sim_waiter.join(max(0.0, SIM_TIMEOUT_S
                                 - (t0 - self.sim_t0)))
        check(not self.sim_waiter.is_alive(),
              f"vgpu-simulate's scale leg ran past {SIM_TIMEOUT_S} s")
        waited = time.monotonic() - t0
        for f in self.sim_files:
            f.close()
        check(self.sim.returncode in (0, 1),
              f"vgpu-simulate's scale leg exited {self.sim.returncode} "
              "(chiprun_out/vgpu_simulate.log)")
        out = simulate_scale_checks(json.loads(self.sim_json.read_text()),
                                    json.loads(SIM_FLEET.read_text()))
        return dict(out, s=self.sim_s, read_waited_s=waited,
                    exit_code=self.sim.returncode)

    def stop(self) -> None:
        for proc in (self.proc, self.sim):
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for f in [self.log, *self.sim_files]:
            if not f.closed:
                f.close()

    def read(self, plane, pods: dict, runs: dict, nofit: dict) -> dict:
        """After V' exits and before ``end``: once the monitor's counters
        for V, H and V' stop moving, the extender's ledger must hold them
        (its register stream beats every second); then the extender's
        exporter, /usagez, /debug/tracez, ``vgpu-report`` and ``vgpu-smi
        top`` are held to them and to the calls this script made.  V''s
        efficiency comes back with the window it covers, unchecked here:
        its bound depends on how V' used its grant (efficiency_skew_bound).
        The capacity simulator's legs: the extender's ``/fleetz`` is held
        to the card and the grants (``fleetz_checks``); ``vgpu-simulate
        --from-cluster`` replays a pod of the card's remaining MiB and one
        of a MiB more (``simulate_live_checks``), in the pool beside
        ``vgpu-report`` and ``vgpu-smi top``, where the scale leg is
        joined (``simulate_scale_checks``)."""
        keys = {pods[k]["key"]: k for k in runs}
        t0 = time.monotonic()
        prev = None
        while True:
            mon, mon_s, mon_bytes, mon_fams = scrape(self.url)
            now = {key: [metric(mon, f"vtpu_usage_{f}_total", container=key)
                         for f in ("chip_seconds", "hbm_byte_seconds")]
                   for key in keys}
            if now == prev and all(None not in v for v in now.values()):
                break
            check(time.monotonic() - t0 < 60,
                  f"the monitor's counters kept moving: {prev} then {now}")
            prev = now
            time.sleep(2 * MONITOR_INTERVAL_S)
        settle_s = time.monotonic() - t0
        status, vars_ = http(f"{self.debug}/debug/vars", timeout=30)
        check(status == 200 and vars_["pid"] == self.proc.pid,
              f"the monitor's /debug/vars answered {status} {vars_}")
        held = plane.call("grants")
        t2 = time.monotonic()
        status, export = http(f"{plane.base}/fleetz", timeout=30)
        fleetz_s = time.monotonic() - t2
        check(status == 200, f"/fleetz answered {status} {export}")
        fleetz = fleetz_checks(export, plane.ready, {
            uid: plane.get_pod(name) for uid, name in held})
        left = plane.ready["hbm_mib"] - fleetz["granted_mib"]
        live_specs = {}
        for name, mib in (("fit", left), ("over", left + 1)):
            path = live_specs[name] = (self.root.parent
                                       / f"vgpu_simulate_{name}.json")
            path.write_text(json.dumps(
                {"pods": [{"name": name, "gpu": 1, "gpumem": mib}]}))
        live = {uid for uid, _ in held}
        names = {key: ("default" if pods[k]["pod"]["metadata"]["uid"] in live
                       else "(unresolved)",
                       pods[k]["pod"]["metadata"]["name"])
                 for key, k in keys.items()}
        t1 = time.monotonic()
        while True:
            ext, ext_s, ext_bytes, ext_fams = scrape(plane.metrics)
            try:
                ledger = ledger_vs_monitor(ext, mon, names)
                break
            except Fail:
                if time.monotonic() - t1 > 10.0:
                    raise
                time.sleep(0.5)
        ledger_s = time.monotonic() - t1
        # A pod's region stays in the monitor's loop after it exits (its
        # dir stays), so V's switch is on, and V is billed throttled
        # seconds, while H runs: recorded, not held to 0.
        throttled = {k: metric(mon, "vtpu_usage_throttled_seconds_total",
                               container=key) for key, k in keys.items()}
        for key, k in keys.items():
            # The census credits up to CENSUS_TICKS past the last
            # launch, and one more tick of the monitor's sleep jitter.
            life = runs[k]["life_s"]
            bound = life + (CENSUS_TICKS + 1) * MONITOR_INTERVAL_S
            check(ledger[key]["chip_seconds"] <= bound,
                  f"{k}: {ledger[key]['chip_seconds']} GPU-seconds in a "
                  f"life of {life} s on the card (bound {bound})")
        uuid = plane.ready["uuid"]
        check(metric(ext, "vtpu_preemption_requests_total") == 1,
              "vtpu_preemption_requests is not 1")
        check(metric(ext, "tpu_device_memory_limit_mib", node=PLUGIN_NODE,
                     deviceuuid=uuid) == plane.ready["hbm_mib"],
              "tpu_device_memory_limit_mib is not the advertised MiB")
        check(metric(ext, "vtpu_node_lease_state", node=PLUGIN_NODE) == 0,
              "the node's lease is not healthy")
        grants = {(x["podnamespace"], x["podname"], x["deviceuuid"]): v
                  for x, v in ext.get("vtpu_pod_device_allocated_mib", [])}
        want = {("default", name, uuid): next(
            p[2] for p in PREEMPT_PODS.values() if p[0] == name)
            for _, name in held}
        check(grants == want, f"vtpu_pod_device_allocated_mib {grants}, "
              f"the grants held {want}")
        counts = {}
        for labels, v in ext.get(
                "vtpu_scheduling_phase_latency_seconds_count", []):
            counts[labels["phase"]] = counts.get(labels["phase"], 0) + v
        # Each allocation is timed twice here: the scheduler's span and
        # the node agent's, which shares the control-plane child.
        calls = dict(filter=len(pods) + 1, bind=len(pods),
                     allocate=2 * len(pods))
        check({k: counts.get(k) for k in calls} == calls,
              f"the extender's phase counts {counts}, the calls {calls}")
        reason = nofit["FailedNodes"][PLUGIN_NODE].split(":", 1)[0].strip()
        check((metric(ext, "vtpu_filter_rejections_total", reason=reason)
               or 0) >= 1, f"vtpu_filter_rejections has no {reason!r}")
        tid = pods["V"]["pod"]["metadata"]["annotations"]["vtpu.dev/trace-id"]
        status, otlp = http(f"{plane.base}/debug/tracez?trace={tid}"
                            "&format=json", timeout=30)
        check(status == 200, f"/debug/tracez answered {status}")
        spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
        # The scheduler's `allocate` carries the bind phase it saw; the
        # node agent's, from the same process, does not.
        agent = [x for x in spans if x["name"] == "allocate" and not any(
            a["key"] == "phase" for a in x["attributes"])]
        trail = [x["name"] for x in sorted(
            spans, key=lambda x: int(x["startTimeUnixNano"]))
            if x not in agent]
        check(trail == ["webhook", "filter", "decision-write", "bind",
                        "allocate"] and len(agent) == 1,
              f"V's trace {trail}, the agent's allocate spans {len(agent)}")
        window = 86400
        t2 = time.monotonic()
        status, usage = http(f"{plane.base}/usagez?window={window}",
                             timeout=30)
        usagez_s = time.monotonic() - t2
        check(status == 200, f"/usagez answered {status} {usage}")

        def command(module, *args, ok=0):
            t0 = time.monotonic()
            res = subprocess.run(
                [sys.executable, "-m", f"k8s_vgpu_scheduler_tpu_torch.cmd."
                 f"{module}", *args], cwd=ROOT, capture_output=True,
                text=True, timeout=120)
            check(res.returncode == ok, f"{module} {args} exited "
                  f"{res.returncode}: {res.stderr.strip()[-2000:]}")
            return json.loads(res.stdout), time.monotonic() - t0

        with ThreadPoolExecutor(5) as pool:
            rep = pool.submit(command, "vgpu_report", "--cluster", plane.base,
                              "--json", "--pods", "--window", str(window))
            top = pool.submit(command, "vgpu_smi", "top", "--cluster",
                              plane.metrics, "--json")
            sims = {name: pool.submit(
                command, "simulate", "--workload", str(path),
                "--from-cluster", plane.base, "--json",
                ok=0 if name == "fit" else 1)
                for name, path in live_specs.items()}
            scale = pool.submit(self.scale_leg)
            (report, report_s), (topv, top_s) = rep.result(), top.result()
            (fit, fit_s), (over, over_s) = (sims["fit"].result(),
                                            sims["over"].result())
            scaled = scale.result()
        simulated = simulate_live_checks(fit, over, plane.ready,
                                         fleetz["granted_mib"], len(held))
        stable = ("uid", "pod", "namespace", "node", "chip_seconds",
                  "hbm_byte_seconds", "granted_chips", "idle", "live")
        rows = [{k: r[k] for k in stable} for r in usage["pods"]]
        check(rows == [{k: r[k] for k in stable} for r in report["pods"]]
              and len(rows) == len(keys),
              f"/usagez's pods {rows}, vgpu-report's {report['pods']}")
        v2 = pods["V2"]["pod"]["metadata"]
        [row] = [r for r in usage["pods"] if r["uid"] == v2["uid"]]
        [trow] = [r for r in topv["pods"] if r["name"] == v2["name"]]
        v2_ledger = ledger[pods["V2"]["key"]]["chip_seconds"]
        check(trow["namespace"] == "default" and trow["chips"] == 1
              and within(trow["chip_seconds"], v2_ledger, 1e-9),
              f"vgpu-smi top's V' {trow}, the ledger's {v2_ledger}")
        out = dict(
            monitor_up_s=self.up_s, settle_s=settle_s, ledger_wait_s=ledger_s,
            monitor_scrape=dict(s=mon_s, bytes=mon_bytes, families=mon_fams,
                                samples=sum(len(v) for v in mon.values())),
            extender_scrape=dict(s=ext_s, bytes=ext_bytes, families=ext_fams,
                                 samples=sum(len(v) for v in ext.values())),
            ledger={keys[k]: v for k, v in ledger.items()},
            life_s={k: runs[k]["life_s"] for k in runs},
            throttled_s=throttled, phase_counts=counts,
            rejection=reason, trace=trail, usagez_s=usagez_s,
            usagez_pods=rows, v2_efficiency=row["efficiency"],
            v2_covered_s=row["window_covered_s"],
            vgpu_report_s=report_s, vgpu_smi_top_s=top_s, top_v2=trow,
            fleetz=dict(fleetz, s=fleetz_s),
            simulate_live=dict(simulated, fit_s=fit_s, over_s=over_s),
            simulate_scale=scaled)
        log("fleet view: " + json.dumps(out))
        return out


def queue_view(plane) -> dict:
    """The capacity queues as the extender's /queuez, its /metrics queue
    families and vgpu-report (in this process, --json) show them, held to
    one another; the /queuez document, its rows by queue name, and the
    report's governed namespace rows."""
    import contextlib
    import io

    from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report

    status, doc = http(f"{plane.base}/queuez", timeout=30)
    check(status == 200 and doc["enabled"], f"/queuez answered {status} "
          f"{doc}")
    metrics = scrape(plane.metrics)[0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = vgpu_report.main(["--cluster", plane.base, "--json",
                                 "--no-capacity", "--no-audit", "--no-slo"])
    check(code == 0, f"vgpu-report exited {code}")
    report = json.loads(out.getvalue())
    rows = {r["queue"]: r for r in doc["queues"]}
    for name, r in rows.items():
        for family, key in (("vtpu_queue_pending", "pending"),
                            ("vtpu_queue_admitted_total", "admitted_total"),
                            ("vtpu_queue_fair_share", "fair_share"),
                            ("vtpu_borrowed_chips", "borrowed_chips")):
            check(metric(metrics, family, queue=name) == r[key],
                  f"{family}{{queue={name}}} "
                  f"{metric(metrics, family, queue=name)}, /queuez {r}")
    check(metric(metrics, "vtpu_reclaims_total") == doc["reclaims_total"],
          f"vtpu_reclaims_total {metric(metrics, 'vtpu_reclaims_total')}, "
          f"/queuez {doc['reclaims_total']}")
    check(report["queues"] == doc["queues"],
          f"vgpu-report's queues {report['queues']}, /queuez {doc}")
    columns = {r["namespace"]: r for r in report["namespaces"]
               if "queue" in r}
    for ns, r in columns.items():
        q = rows[r["queue"]]
        check(ns in q["namespaces"] and (r["nominal_chips"], r["held_chips"],
                                         r["borrowed_chips"])
              == (q["nominal_chips"], q["held_chips"], q["borrowed_chips"]),
              f"vgpu-report's row {r}, /queuez {q}")
    check(not any("default" in q["namespaces"] for q in doc["queues"]),
          f"a queue governs the default namespace: {doc}")
    return dict(queuez=doc, rows=rows, report_rows=columns)


def quota_leg(plane, uuid: str, volumes: Path, tmp: Path, children: list,
              gang=None) -> dict:
    """The capacity queues on the card, after V' and before the rescuer's
    sweeps.  B (team-a, all borrowed) goes through the webhook (queue and
    held state stamped) and is held by Filter; a tick of the admission
    loop releases it, Filter and Bind place it, and it runs its loop on
    the card under Allocate's env (``child_quota_pod``).  Once it runs, E
    (team-b, entitled to a card; its MiB does not fit beside B's) is
    admitted and held; the next tick cannot release it (the cohort's one
    nominal card is B's borrowed one) and reclaims: the eviction request
    on B, which this process mirrors into B's downward-API file as kubelet
    does.  B exits 0, its pod is deleted and its grant frees; the next
    tick releases E, which is placed with its own MiB.  At each step
    /queuez, /metrics and vgpu-report agree (queue_view).  ``gang`` (a
    GangLeg) runs its first half while E and V' hold their grants, and
    its second once E is deleted."""
    from k8s_vgpu_scheduler_tpu_torch.quota.queues import (
        QUEUE_ANNOTATION, QUEUE_POSITION_ANNOTATION, QUEUE_STATE_ANNOTATION)
    from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import \
        PREEMPT_ANNOTATION

    t_leg = time.monotonic()
    views, t, out = {}, {}, {}
    hs = {"B": {}, "E": {}}

    def admit(key: str) -> dict:
        name, uid, ns = QUOTA_PODS[key]
        created, hs[key] = admit_pod(plane.base, plane, user_pod(
            name, uid, QUOTA_MIB, 1, namespace=ns))
        anns = created["metadata"]["annotations"]
        check(anns.get(QUEUE_ANNOTATION) == ns
              and anns.get(QUEUE_STATE_ANNOTATION) == "held",
              f"{name}: the webhook's queue annotations {anns}")
        reply, _ = filter_pod(plane.base, created, PLUGIN_NODE)
        t[f"{key}_held"] = time.monotonic()
        check(reply["NodeNames"] == [] and reply["Error"].startswith(
            f"held in capacity queue {ns} (position 1/1"),
            f"{name}: Filter answered {reply}")
        hs[key]["hold"] = reply
        return created

    def tick(key: str) -> list:
        acts = plane.call("tick")
        t[key] = time.monotonic()
        out.setdefault("ticks", []).append(acts)
        return acts

    def place(key: str) -> dict:
        name, uid, ns = QUOTA_PODS[key]
        place_pod(plane.base, plane.get_pod(name, ns), PLUGIN_NODE, hs[key])
        t[f"{key}_placed"] = time.monotonic()
        got = plane.call("allocate")
        pod = dict(key=f"{uid}_{name}", grant_mib=QUOTA_MIB, priority=1,
                   pod=plane.get_pod(name, ns), handshake=hs[key],
                   response=got["response"], locked=got["locked"])
        check(pod["pod"]["metadata"]["annotations"]["vtpu.dev/bind-phase"]
              == "success" and not pod["locked"],
              f"{name}: bind phase, lock {pod['locked']}")
        placed(name, pod, uuid, cores=0)
        pod["env"] = kubelet_env(pod["pod"], pod["response"], volumes)
        return pod

    def admits(acts) -> list:
        return [a["pod"] for a in acts if a["kind"] == "admit"]

    admit("B")
    views["b_held"] = queue_view(plane)
    a = views["b_held"]["rows"]["team-a"]
    check((a["pending"], a["held_chips"], a["admitted_total"])
          == (1, 0, 0), f"team-a with B held: {a}")
    check(admits(tick("B_released")) == ["team-a/borrower"],
          f"the tick after B: {out['ticks'][-1]}")
    b = place("B")
    views["b_placed"] = queue_view(plane)
    a = views["b_placed"]["rows"]["team-a"]
    check((a["pending"], a["held_chips"], a["borrowed_chips"],
           a["admitted_total"]) == (0, 1, 1, 1),
          f"team-a with B placed: {a}")
    check(views["b_placed"]["report_rows"]["team-a"]["borrowed_chips"] == 1,
          f"vgpu-report with B placed {views['b_placed']['report_rows']}")
    grant = dict(b["env"])
    child = EnforceChild("quota_pod", tmp, label="quota_B",
                         region=grant.pop("CUDA_DEVICE_MEMORY_SHARED_CACHE"),
                         **grant)
    children.append(child)

    def kubelet(line: str) -> None:
        """On B's first loop: E arrives, is held, and the tick reclaims;
        B's annotations go into its downward-API file."""
        if line != "LOOP 1" or "E_held" in t:
            return
        admit("E")
        acts = tick("reclaim")
        out["reclaim"] = [x for x in acts if x["kind"] == "reclaim"]
        out["e_blocked"] = not admits(acts)
        views["reclaim"] = queue_view(plane)
        out["b_annotations"] = anns = plane.get_pod(
            QUOTA_PODS["B"][0], "team-a")["metadata"]["annotations"]
        out["e_position"] = plane.get_pod(
            QUOTA_PODS["E"][0], "team-b")["metadata"]["annotations"].get(
                QUEUE_POSITION_ANNOTATION)
        path = Path(b["env"]["VTPU_PODINFO_ANNOTATIONS"])
        staged = path.with_name(".annotations")
        staged.write_text(podinfo_text(anns))
        os.replace(staged, path)
        t["mirrored"] = time.monotonic()

    ran = child.run({}, "quota", kubelet)
    t["B_exit"] = time.monotonic()
    check("E_held" in t, "B never printed LOOP 1")
    plane.call("delete", name=QUOTA_PODS["B"][0], namespace="team-a")
    check(admits(tick("E_released")) == ["team-b/entitled"],
          f"the tick after B's exit: {out['ticks'][-1]}")
    views["e_released"] = queue_view(plane)
    e = place("E")
    views["e_placed"] = queue_view(plane)
    requested = plane.call("requested")
    if gang is not None:
        gang.hold()
    plane.call("delete", name=QUOTA_PODS["E"][0], namespace="team-b")
    if gang is not None:
        gang.place_and_run()

    b_uid, e_uid = QUOTA_PODS["B"][1], QUOTA_PODS["E"][1]
    [recl] = out["reclaim"] or [None]
    check(recl is not None and out["e_blocked"]
          and recl["for"] == "team-b/entitled"
          and [(v["uid"], v["donor_borrowed"]) for v in recl["victims"]]
          == [(b_uid, 1)], f"the reclaim tick: {out['ticks'][1]}")
    check(out["b_annotations"].get(PREEMPT_ANNOTATION) == e_uid
          and requested.get(b_uid, [None])[0] == e_uid,
          f"B's annotations {out['b_annotations']}, requests {requested}")
    check(out["e_position"] == "1/1", f"E's position {out['e_position']}")
    check(ran["requester"] == e_uid and ran["loops"] >= 1,
          f"B stopped on {ran['requester']} after {ran['loops']} loops")
    rv = views["reclaim"]["rows"]
    check(rv["team-b"]["pending"] == 1 and rv["team-a"]["borrowed_chips"] == 1
          and views["reclaim"]["queuez"]["reclaims_total"] == 1,
          f"the queues at the reclaim: {rv}")
    er = views["e_released"]["rows"]
    check(er["team-a"]["held_chips"] == 0 and er["team-a"][
        "borrowed_chips"] == 0 and er["team-b"]["admitted_total"] == 1
          and er["team-b"]["pending"] == 0,
          f"the queues after B's exit: {er}")
    ep = views["e_placed"]["rows"]["team-b"]
    check((ep["held_chips"], ep["borrowed_chips"]) == (1, 0),
          f"team-b with E placed: {ep}")
    check(e["env"]["CUDA_DEVICE_MEMORY_LIMIT_0"] == str(QUOTA_MIB),
          f"E's env {e['env']}")
    return {
        "queues": QUOTA_QUEUES, "mib": QUOTA_MIB,
        "reclaim_grace_s": QUOTA_GRACE_S, "fleet_headroom": QUOTA_HEADROOM,
        "reclaim": recl, "e_blocked_by": "the release loop (cohort cap)",
        "b_loops": ran["loops"], "b_interposer": ran["interposer"],
        "b_hold_to_release_s": t["B_released"] - t["B_held"],
        "b_release_to_placed_s": t["B_placed"] - t["B_released"],
        "reclaim_to_b_stop_seen_s": ran["stop_seen_t"] - t["reclaim"],
        "reclaim_to_b_exit_s": t["B_exit"] - t["reclaim"],
        "annotation_written_to_mirrored_s":
            t["mirrored"] - requested[b_uid][1],
        "b_exit_to_e_placed_s": t["E_placed"] - t["B_exit"],
        "e_hold_to_release_s": t["E_released"] - t["E_held"],
        "calls_s": {k: {c: hs[k][f"{c}_s"] for c in ("webhook", "filter",
                                                     "bind")}
                    for k in hs},
        "queuez": {k: v["queuez"] for k, v in views.items()},
        "seconds": time.monotonic() - t_leg}


class GangLeg:
    """A pod group on the card, inside quota_leg (no phase of its own):
    ring-0 and ring-1 of GANG_GROUP, total 2, in team-g, with a
    coordinator on a free local port.

    ``hold``, while E and V' hold their grants (the card's remainder, read
    from /fleetz, fits one member and not two): each member goes through
    the webhook (queue and held state stamped) and Filter holds it; a tick
    with one member holds it (blocked: ``gang ring accumulating (1/2)``),
    a tick with both releases both (``gang: ring``).  Then Filter answers
    ring-0 ``gang ring waiting (1/2)`` and ring-1 ``gang ring: no atomic
    placement for 2 members``, and /fleetz shows neither uid and no more
    MiB granted.

    ``place_and_run``, after E's delete: ring-0's Filter places both
    members on the card (both grants recorded at once), each with its
    MiB and its rank annotation (0, 1); each Bind ends ``success`` with
    the lock released and each Allocate answer carries the gang env.
    Both members start together under their answers' env
    (``child_gang_member``): one gloo group, the flash kernel held to the
    plain version, the same reduced values on both ranks, no refusal, the
    interposer's charge within the grant.  Both are deleted: their grants
    leave /fleetz, the gang registry is empty, /queuez holds no gang
    entry.  /queuez, /metrics and vgpu-report agree after the release,
    the placement and the deletes (queue_view)."""

    def __init__(self, plane, uuid: str, volumes: Path, tmp: Path,
                 children: list, record: dict) -> None:
        self.plane, self.uuid, self.volumes, self.tmp = (plane, uuid,
                                                         volumes, tmp)
        self.children, self.record = children, record
        self.t, self.out, self.views, self.hs = {}, {}, {}, {}
        self.t0 = None

    def fleet(self) -> tuple:
        """The card's MiB less its grants, and the granted uids, as
        /fleetz shows them."""
        t0 = time.monotonic()
        status, doc = http(f"{self.plane.base}/fleetz", timeout=30)
        self.out.setdefault("fleetz_s", []).append(time.monotonic() - t0)
        check(status == 200, f"/fleetz answered {status} {doc}")
        [card] = [c for n in doc["nodes"] for c in n["chips"]
                  if c["id"] == self.uuid]
        granted = sum(d["usedmem"] for p in doc["pods"]
                      for ctr in p["devices"] for d in ctr
                      if d["uuid"] == self.uuid)
        return card["devmem"] - granted, {p["uid"] for p in doc["pods"]}

    def filter(self, name: str) -> dict:
        reply, sec = filter_pod(self.plane.base,
                                self.plane.get_pod(name, GANG_NS),
                                PLUGIN_NODE)
        self.out.setdefault("filter_s", {}).setdefault(name, []).append(sec)
        return reply

    def tick(self, key: str) -> list:
        t0 = time.monotonic()
        acts = self.plane.call("tick")
        self.t[key] = time.monotonic()
        self.out.setdefault("tick_s", {})[key] = self.t[key] - t0
        self.out.setdefault("ticks", []).append(acts)
        return acts

    def hold(self) -> None:
        from k8s_vgpu_scheduler_tpu_torch.quota.queues import (
            QUEUE_ANNOTATION, QUEUE_STATE_ANNOTATION)
        from k8s_vgpu_scheduler_tpu_torch.util.types import (
            GANG_COORDINATOR_ANNOTATION, GANG_GROUP_ANNOTATION,
            GANG_TOTAL_ANNOTATION)

        self.t0 = time.monotonic()
        remaining, uids = self.fleet()
        mib = GANG_MIB if GANG_MIB <= remaining < 2 * GANG_MIB \
            else remaining * 2 // 3
        check(0 < mib <= remaining < 2 * mib
              and 2 * mib <= remaining + QUOTA_MIB,
              f"{mib} MiB a member against the card's remaining "
              f"{remaining} MiB (E's {QUOTA_MIB} MiB to come back)")
        self.mib, self.remaining = mib, remaining
        self.coordinator = f"127.0.0.1:{free_port()}"
        anns = {GANG_GROUP_ANNOTATION: GANG_GROUP,
                GANG_TOTAL_ANNOTATION: str(len(GANG_PODS)),
                GANG_COORDINATOR_ANNOTATION: self.coordinator}
        admitted = []
        for i, (name, uid) in enumerate(GANG_PODS):
            created, self.hs[name] = admit_pod(
                self.plane.base, self.plane, user_pod(
                    name, uid, mib, 1, annotations=anns,
                    namespace=GANG_NS))
            got = created["metadata"]["annotations"]
            check(got.get(QUEUE_ANNOTATION) == GANG_NS
                  and got.get(QUEUE_STATE_ANNOTATION) == "held",
                  f"{name}: the webhook's queue annotations {got}")
            reply = self.filter(name)
            check(reply["NodeNames"] == [] and reply["Error"].startswith(
                f"held in capacity queue {GANG_NS} (position {i + 1}/"
                f"{i + 1}"), f"{name}: Filter answered {reply}")
            acts = self.tick(f"tick_{i + 1}")
            admitted = [a for a in acts if a["kind"] == "admit"]
            if i == 0:
                blocked = self.plane.call("blocked")
                self.out["blocked"] = blocked
                check(admitted == [] and blocked.get(GANG_NS) == [
                    uid, f"gang {GANG_GROUP} accumulating (1/2)"],
                      f"the tick with one member: {acts}, blocked "
                      f"{blocked}")
        check(sorted(a["pod"] for a in admitted)
              == [f"{GANG_NS}/{n}" for n, _ in GANG_PODS]
              and all(a["gang"] == GANG_GROUP for a in admitted),
              f"the tick with both members: {self.out['ticks'][-1]}")
        self.views["released"] = queue_view(self.plane)
        g = self.views["released"]["rows"][GANG_NS]
        check((g["pending"], g["admitted_total"]) == (0, 2),
              f"team-g with the gang released: {g}")
        first = self.filter(GANG_PODS[0][0])
        second = self.filter(GANG_PODS[1][0])
        self.out["waiting"], self.out["no_fit"] = first, second
        check(first["NodeNames"] == [] and first["Error"]
              == f"gang {GANG_GROUP} waiting (1/2)",
              f"ring-0's Filter beside E: {first}")
        check(second["NodeNames"] == [] and second["Error"]
              == f"gang {GANG_GROUP}: no atomic placement for 2 members",
              f"ring-1's Filter beside E: {second}")
        left, uids_after = self.fleet()
        check(left == remaining and not uids_after
              & {u for _, u in GANG_PODS},
              f"/fleetz after the refused placement: {left} of {remaining} "
              f"MiB left, uids {sorted(uids_after)}")
        self.t["held_done"] = time.monotonic()

    def place_and_run(self) -> None:
        from k8s_vgpu_scheduler_tpu_torch.util.types import \
            GANG_RANK_ANNOTATION

        t_release = time.monotonic()
        pods = {}
        for i, (name, uid) in enumerate(GANG_PODS):
            hs = self.hs[name]
            place_pod(self.plane.base, self.plane.get_pod(name, GANG_NS),
                      PLUGIN_NODE, hs)
            self.out.setdefault("filter_s", {}).setdefault(name, []).append(
                hs["filter_s"])
            if i == 0:
                self.t["placed"] = time.monotonic()
                grants = {u for u, _ in self.plane.call("grants")}
                check({u for _, u in GANG_PODS} <= grants,
                      f"ring-0's Filter placed {sorted(grants)}")
            got = self.plane.call("allocate")
            hs["allocate_s"] = got["allocate_s"]
            pod = dict(key=f"{uid}_{name}", grant_mib=self.mib, priority=1,
                       pod=self.plane.get_pod(name, GANG_NS), handshake=hs,
                       response=got["response"], locked=got["locked"])
            anns = pod["pod"]["metadata"]["annotations"]
            check(anns["vtpu.dev/bind-phase"] == "success"
                  and not pod["locked"], f"{name}: bind phase, lock "
                  f"{pod['locked']}")
            check(anns.get(GANG_RANK_ANNOTATION) == str(i),
                  f"{name}: rank annotation {anns.get(GANG_RANK_ANNOTATION)}")
            placed(name, pod, self.uuid, cores=0)
            envs = pod["response"]["envs"]
            check(envs.get("VTPU_GANG_RANK") == str(i)
                  and envs.get("VTPU_GANG_SIZE") == str(len(GANG_PODS))
                  and envs.get("VTPU_GANG_GROUP") == GANG_GROUP
                  and envs.get("VTPU_GANG_COORDINATOR") == self.coordinator,
                  f"{name}: Allocate's gang env {envs}")
            pod["env"] = kubelet_env(pod["pod"], pod["response"],
                                     self.volumes)
            pods[name] = pod
        self.views["placed"] = queue_view(self.plane)
        members = []
        for name, pod in pods.items():
            grant = dict(pod["env"])
            # The members run on one host: the loopback is their network.
            grant["GLOO_SOCKET_IFNAME"] = "lo"
            child = EnforceChild(
                "gang_member", self.tmp, label=f"gang_{name}",
                region=grant.pop("CUDA_DEVICE_MEMORY_SHARED_CACHE"), **grant)
            self.children.append(child)
            members.append(child)
        t_start = time.monotonic()
        with ThreadPoolExecutor(len(members)) as pool:
            futs = [pool.submit(c.run, self.record, "gang") for c in members]
            runs = [f.result() for f in futs]
        self.t["members_done"] = time.monotonic()
        for run in runs:
            check(run["size"] == len(GANG_PODS) and run["launches"] == 1,
                  f"rank {run['rank']}: size {run['size']}, "
                  f"{run['launches']} launches")
            stats = run["interposer"]
            check(stats["refusals"] == 0 and stats["context_bytes"]
                  + stats["alloc_bytes"] <= self.mib * MIB,
                  f"rank {run['rank']}: the interposer's counters {stats} "
                  f"past a {self.mib} MiB grant")
        check(sorted(r["rank"] for r in runs) == list(range(len(GANG_PODS))),
              f"ranks {[r['rank'] for r in runs]}")
        check(len({(r["max_rel_err_all"], r["checksum_all"])
                   for r in runs}) == 1
              and runs[0]["max_rel_err_all"] == max(
                  r["errors"]["rel_max_err"] for r in runs),
              f"the reduced values differ: "
              f"{[(r['max_rel_err_all'], r['checksum_all']) for r in runs]}")
        for name, _ in GANG_PODS:
            self.plane.call("delete", name=name, namespace=GANG_NS)
        _, uids = self.fleet()
        gangs = self.plane.call("gangs")
        self.views["deleted"] = queue_view(self.plane)
        check(not uids & {u for _, u in GANG_PODS} and gangs == {},
              f"after the deletes: /fleetz uids {sorted(uids)}, gangs "
              f"{gangs}")
        check(not any(p.get("gang") for q in
                      self.views["deleted"]["queuez"]["queues"]
                      for p in q["pending_pods"]),
              f"/queuez after the deletes {self.views['deleted']['queuez']}")
        self.summary = {
            "mib": self.mib, "card_remaining_mib": self.remaining,
            "coordinator": self.coordinator,
            "blocked": self.out["blocked"],
            "waiting": self.out["waiting"]["Error"],
            "no_fit": self.out["no_fit"]["Error"],
            "filter_s": self.out["filter_s"], "tick_s": self.out["tick_s"],
            "fleetz_s": self.out["fleetz_s"],
            "calls_s": {n: {c: self.hs[n][f"{c}_s"] for c in (
                "webhook", "filter", "bind", "allocate")}
                for n, _ in GANG_PODS},
            "release_to_placed_s": self.t["placed"] - t_release,
            "start_to_rendezvous_s": [r["joined_t"] - t_start
                                      for r in runs],
            "rendezvous_s": [r["rendezvous_s"] for r in runs],
            "members_s": self.t["members_done"] - t_start,
            "max_rel_err_all": runs[0]["max_rel_err_all"],
            "checksum_all": runs[0]["checksum_all"],
            "errors": [r["errors"] for r in runs],
            "interposer": [r["interposer"] for r in runs],
            "queuez": {k: v["queuez"] for k, v in self.views.items()},
            "seconds": time.monotonic() - self.t0}


def phase_preempt(torch, record, vgpu: Path, interposer: Path):
    """Checkpoint-first eviction on the card, planned by the port's
    scheduler.  The control plane (PlaneChild: the extender with
    ``enable_preemption``, the register stream from NVML, the device
    plugin) stays up for the whole phase; this process drives it as
    kube-scheduler and acts as kubelet.  Four pods of the PREEMPT_LAYERS
    layer train step through the interposer: R runs PREEMPT_STEPS
    uninterrupted, checkpointing to the disk, under a grant of its own
    (not placed).  V, priority 1, PREEMPT_MIB, written with resources only,
    is placed by the webhook, Filter and Bind and runs under the env a
    kubelet builds from Allocate's answer, checkpointing to SHM.  Once V
    has finished step PREEMPT_AFTER, H (priority 0, PREEMPT_H_MIB, which
    does not fit beside V, ``vtpu.dev/oversubscribe``) is admitted: its
    Filter must find no node, and the scheduler must write
    ``vtpu.dev/preempt-requested=<H's uid>`` on V.  This process mirrors V's
    annotations, as the apiserver holds them, into V's downward-API file
    (``os.replace``; it never writes the value).  V must checkpoint at
    the next boundary and exit 0; its pod is deleted, the informer frees
    its grant, and H's next Filter must place H on the card with its own
    MiB.  H runs interposer_swap under Allocate's env alone
    (``child_preempt_swap``): the startup hook installs the shim, the
    AdamW state spills at the gate with no refusal and comes back bit for
    bit, and H's losses are R's first ones.  H's pod is deleted; V', a new
    pod on V's checkpoints, is placed by the extender and finishes.  V''s
    losses and its final checkpoint must be R's bit for bit, the card's
    memory must return to this process's within RETURN_S of V's exit
    (read before H starts), and V's region must hold no used bytes.  Last,
    the control plane's register stream closes and its rescuer sweeps
    twice on an advanced lease clock: HEALTHY -> SUSPECT with nothing
    rescinded, then SUSPECT -> DEAD, rescinding V''s grant (its finished
    pod left in the apiserver) with its decision annotations cleared; the
    card's used memory stays flat through the sweeps.  Through the phase
    ``vgpu-monitor`` runs as a process over the containers dir and the
    control plane's register stream carries its counters (FleetView);
    after V' exits the extender's ledger, exporter, /usagez, trace,
    vgpu-report and vgpu-smi top are held to them, and ``vgpu-simulate``
    to the extender's /fleetz and to a 1,024-card fleet
    (``FleetView.read``).  Then the capacity queues' leg (``quota_leg``)
    runs B and E in the governed team-a and team-b, while R, V, H and V'
    stay in "default": no queue annotation, their flow unchanged.
    Returns the port kernels' launches in R, V, H and V'."""
    from k8s_vgpu_scheduler_tpu_torch.monitor import RegionReader
    from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import \
        PREEMPT_ANNOTATION

    uuid = nvidia_smi("uuid")
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    check(SHM.is_dir(), f"no {SHM} for V's checkpoints")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(GRANT_ENV)}
    names = {k: v[0] for k, v in PREEMPT_PODS.items()}
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory(dir=SHM) as shm:
        tmp, shm = Path(tmp), Path(shm)
        disk, shm_space = shutil.disk_usage(tmp), shutil.disk_usage(shm)
        host_free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        (tmp / "containers").mkdir()
        volumes = tmp / "volumes"
        fleet = FleetView(tmp / "containers", vgpu, env)
        quota_config = tmp / "quota.json"
        quota_config.write_text(json.dumps({"queues": QUOTA_QUEUES}))
        try:
            plane = PlaneChild({**env, "PLUGIN_DIR": str(tmp),
                                "USAGE_FROM": fleet.grpc,
                                "QUOTA_CONFIG": str(quota_config)})
        except BaseException:
            fleet.stop()
            raise
        install_s = plane.ready["install_shim_s"]
        check(plane.ready["shim_files"] == [
            "ld.so.preload", "libvgpu_cuda.so", "sitecustomize.py"],
            f"the node agent's shim dir {plane.ready['shim_files']}")
        children, pods = [], {}

        def schedule(key: str) -> dict:
            """One of PREEMPT_PODS through the webhook, Filter, Bind and
            Allocate; its spec, answer and the env a kubelet builds."""
            name, uid, mib, priority, anns = PREEMPT_PODS[key]
            created, hs = admit_pod(plane.base, plane,
                                    user_pod(name, uid, mib, priority,
                                             annotations=anns))
            place_pod(plane.base, created, PLUGIN_NODE, hs)
            return allocated(key, hs)

        def allocated(key: str, hs: dict) -> dict:
            name, uid, mib, priority, _ = PREEMPT_PODS[key]
            got = plane.call("allocate")
            hs["allocate_s"] = got["allocate_s"]
            pod = dict(key=f"{uid}_{name}", grant_mib=mib, priority=priority,
                       pod=plane.get_pod(name), handshake=hs,
                       response=got["response"], locked=got["locked"])
            check(pod["pod"]["metadata"]["annotations"][
                "vtpu.dev/bind-phase"] == "success" and not pod["locked"],
                  f"{name}: bind phase, lock {pod['locked']}")
            placed(name, pod, uuid, cores=0)
            pod["env"] = kubelet_env(pod["pod"], pod["response"], volumes)
            pods[key] = pod
            return pod

        def pod_child(key: str, name: str, **extra) -> EnforceChild:
            grant = dict(pods[key]["env"])
            child = EnforceChild(
                name, tmp, label=f"preempt_{key}",
                region=grant.pop("CUDA_DEVICE_MEMORY_SHARED_CACHE"),
                **extra, **grant)
            children.append(child)
            return child

        events = {}

        def kubelet(line: str) -> None:
            """On V's STEP PREEMPT_AFTER: H arrives; once its Filter has
            answered, V's annotations go into V's downward-API file."""
            if line != f"STEP {PREEMPT_AFTER}" or events:
                return
            name, uid, mib, priority, anns = PREEMPT_PODS["H"]
            created, hs = admit_pod(plane.base, plane, user_pod(
                name, uid, mib, priority, annotations=anns))
            events["nofit_sent"] = time.monotonic()
            hs["nofit"], hs["nofit_s"] = filter_pod(plane.base, created,
                                                    PLUGIN_NODE)
            events["nofit"] = time.monotonic()
            events["h"] = hs
            annotations = plane.get_pod(names["V"])["metadata"][
                "annotations"]
            path = Path(pods["V"]["env"]["VTPU_PODINFO_ANNOTATIONS"])
            staged = path.with_name(".annotations")
            staged.write_text(podinfo_text(annotations))
            os.replace(staged, path)
            events["mirrored"] = time.monotonic()
            events["v_annotations"] = annotations

        try:
            check(plane.ready["uuid"] == uuid,
                  f"the control plane's card {plane.ready} is not {uuid}")
            (tmp / "preempt_R").mkdir()
            r_annotations = tmp / "preempt_R" / "annotations"
            r_annotations.write_text('kubernetes.io/config.seen="2026"\n')
            r = EnforceChild(
                "preempt", tmp, label="preempt_R", LD_PRELOAD=interposer,
                NVIDIA_VISIBLE_DEVICES=uuid,
                CUDA_DEVICE_MEMORY_LIMIT_0=f"{PREEMPT_MIB}m",
                PREEMPT_DIR=tmp / "R",
                VTPU_PODINFO_ANNOTATIONS=r_annotations)
            children.append(r)
            schedule("V")
            v = pod_child("V", "preempt", PREEMPT_DIR=shm / "V")
            baseline = smi_card_mib()  # this process alone on the card
            ref = r.run(record, "preempt")
            victim = v.run(record, "preempt", kubelet)
            exited = time.monotonic()
            check(bool(events), f"V never printed STEP {PREEMPT_AFTER}")
            plane.call("delete", name=names["V"])
            deleted = time.monotonic()
            back, smi_after = None, []
            while time.monotonic() - exited < RETURN_S and back is None:
                smi_after.append(smi_card_mib())
                if smi_after[-1] <= baseline + TOL_RETURN_MIB:
                    back = time.monotonic() - exited
            reader = RegionReader(str(vgpu))
            region = reader.open(str(tmp / "containers" / pods["V"]["key"]
                                     / "cudevshr.cache"))
            check(region is not None, "V's region is gone")
            try:
                v_used, v_pids = region.used(0), region.proc_pids()
            finally:
                region.close()
            # H's next Filter, as kube-scheduler retries a pending pod.
            h_hs = events["h"]
            place_pod(plane.base, plane.get_pod(names["H"]), PLUGIN_NODE,
                      h_hs)
            h_placed = time.monotonic()
            allocated("H", h_hs)
            swap = pod_child("H", "preempt_swap").run(record, "preempt")
            plane.call("delete", name=names["H"])
            schedule("V2")
            resumed = pod_child("V2", "preempt",
                                PREEMPT_DIR=shm / "V").run(record, "preempt")
            requested = plane.call("requested")
            observed = fleet.read(plane, pods, {
                "V": victim, "H": swap, "V2": resumed}, events["h"]["nofit"])
            check(observed["v2_efficiency"] is not None
                  and 0 < observed["v2_efficiency"] <= 1,
                  f"V''s efficiency {observed['v2_efficiency']}")
            gang = GangLeg(plane, uuid, volumes, tmp, children, record)
            quota = quota_leg(plane, uuid, volumes, tmp, children,
                              gang=gang)
            smi_end = [smi_card_mib()]
            ended = plane.call("end")
            smi_end.append(smi_card_mib())
            check(plane.close() == 0, "the control plane exited non-zero")
        finally:
            for child in children:
                child.stop()
            plane.close()
            fleet.stop()
        k = victim["done"]
        t0 = time.monotonic()
        final = same_checkpoints(torch, tmp / "R" / str(PREEMPT_STEPS) /
                                 "state.pt",
                                 shm / "V" / str(PREEMPT_STEPS) / "state.pt")
        compare_s = time.monotonic() - t0
        shutil.rmtree(tmp / "R")
        shutil.rmtree(shm / "V")
    h_uid, v_uid = PREEMPT_PODS["H"][1], PREEMPT_PODS["V"][1]
    nofit = events["h"]["nofit"]
    check(nofit["NodeNames"] == [] and nofit["Error"]
          and nofit["FailedNodes"].get(PLUGIN_NODE, "").startswith(
              "insufficient-hbm"),
          f"H's first Filter answered {nofit}")
    check(events["v_annotations"].get(PREEMPT_ANNOTATION) == h_uid
          and list(requested) == [v_uid] and requested[v_uid][0] == h_uid,
          f"the scheduler's requests {requested}, V's annotations "
          f"{events['v_annotations']}")
    check(ref["done"] == PREEMPT_STEPS and not ref["preempted"]
          and len(ref["losses"]) == PREEMPT_STEPS,
          f"R: {ref['done']} steps, preempted {ref['preempted']}")
    check(victim["preempted"] and PREEMPT_AFTER <= k < PREEMPT_STEPS
          and victim["requester"] == h_uid,
          f"V: preempted {victim['preempted']} at step {k}, requester "
          f"{victim['requester']}")
    check([s["step"] for s in victim["io"]["saves"]] == [k],
          f"V's saves {victim['io']['saves']}")
    check(resumed["done"] == PREEMPT_STEPS and not resumed["preempted"]
          and resumed["first_step"] == k + 1
          and [s["step"] for s in resumed["io"]["restores"]] == [k],
          f"V': from step {resumed['first_step']} to {resumed['done']}, "
          f"restores {resumed['io']['restores']}")
    check(victim["losses"] == ref["losses"][:k]
          and resumed["losses"] == ref["losses"][k:],
          f"losses: R {ref['losses']}, V {victim['losses']}, V' "
          f"{resumed['losses']}")
    check(all(final["equal"].values()),
          f"the step-{PREEMPT_STEPS} checkpoints differ: {final['equal']}")
    check(back is not None, f"the card read {smi_after} MiB for {RETURN_S} "
          f"s after V's exit, the parent {baseline} MiB")
    check(v_used == 0 and v.proc.pid not in v_pids,
          f"V's region: used {v_used}, pids {v_pids} (V was {v.proc.pid})")
    h_env = pods["H"]["env"]
    check(h_env.get("CUDA_OVERSUBSCRIBE") == "true"
          and h_env.get("PYTHONPATH") == str(tmp / "shim"),
          f"H's env from Allocate {h_env}")
    check(swap["losses"] == ref["losses"][:len(swap["losses"])],
          f"H's losses {swap['losses']} are not R's {ref['losses']}")
    held = {uid for uid, _ in ended["held"]}
    dead_rescued = [a for a in ended["dead"]["actions"]
                    if a["kind"] == "rescued"]
    check(ended["suspect"]["actions"] == [
        {"kind": "lease", "node": PLUGIN_NODE, "from": "HEALTHY",
         "to": "SUSPECT"}] and {u for u, _ in ended["suspect"]["left"]}
          == held, f"the sweep in the Suspect window: {ended['suspect']}")
    check(ended["dead"]["actions"][0] == {
        "kind": "lease", "node": PLUGIN_NODE, "from": "SUSPECT",
        "to": "DEAD"} and {a["uid"] for a in dead_rescued} == held
          and held == {PREEMPT_PODS["V2"][1]}
          and all(a["via"] == "rescind" and a["reason"] == "node-dead"
                  for a in dead_rescued)
          and not ended["dead"]["left"] and not ended["registered"],
          f"the sweep past the Dead deadline: {ended['dead']}, held "
          f"{ended['held']}")
    check(all(anns.get(key) == "" for anns in ended["annotations"].values()
              for key in ("vtpu.dev/assigned-node", "vtpu.dev/assigned-ids",
                          "vtpu.dev/devices-to-allocate",
                          "vtpu.dev/bind-phase")),
          f"decision annotations after the rescue {ended['annotations']}")
    check(not ended["torch_loaded"], "the control plane loaded torch")
    for key, pod in pods.items():
        queued = {k for k in (*pod["pod"]["metadata"]["annotations"],
                              *(op["path"] for op in pod["handshake"]["patch"]))
                  if "queue" in k}
        check(not queued, f"{key} (ungoverned) got queue annotations "
              f"{queued}")
    check(max(smi_end) - min(smi_end) <= TOL_RETURN_MIB,
          f"the card's memory moved through the sweeps: {smi_end} MiB")
    saves = [s for run in (ref, victim, resumed) for s in run["io"]["saves"]]
    swapped = swap["host_swap"]
    summary = record["preempt_summary"] = {
        "phase": "preempt", "card": record["card"],
        "seconds": time.monotonic() - t_phase, "install_shim_s": install_s,
        "disk_free_bytes": disk.free, "disk_total_bytes": disk.total,
        "shm_free_bytes": shm_space.free, "host_free_bytes": host_free,
        "preempted_at_step": k,
        "calls_s": {key: {c: pod["handshake"][f"{c}_s"] for c in (
            "webhook", "filter", "bind", "allocate")}
            for key, pod in pods.items()},
        "h_nofit_filter_s": events["h"]["nofit_s"],
        "nofit_filter_to_annotation_written_s":
            requested[v_uid][1] - events["nofit_sent"],
        "annotation_written_to_mirrored_s":
            events["mirrored"] - requested[v_uid][1],
        "annotation_written_to_stop_seen_s":
            victim["stop_seen_t"] - requested[v_uid][1],
        "annotation_to_exit_s": exited - requested[v_uid][1],
        "victim_exit_to_h_placed_s": h_placed - exited,
        "victim_exit_to_deleted_s": deleted - exited,
        "victim_exit_t_to_parent_s": exited - victim["exit_t"],
        "h_spill_s": swapped["suspend_s"], "h_resume_s": swapped["resume_s"],
        "h_state_bytes": swapped["state_bytes"], "h_freed": swap["freed"],
        "h_pressure": swap["pressure"], "h_shim_source": swap["shim_source"],
        "h_losses": swap["losses"],
        "save_s": [s["s"] for s in saves],
        "restore_s": [x["s"] for x in resumed["io"]["restores"]],
        "checkpoint_bytes": saves[0]["bytes"],
        "compare_s": compare_s, "compared_tensors": final["tensors"],
        "smi_baseline_mib": baseline, "smi_after_exit_mib": smi_after,
        "memory_back_s": back, "victim_region_used": v_used,
        "smi_through_sweeps_mib": smi_end,
        "sweeps": {k: ended[k] for k in ("suspect", "dead")},
        "losses": ref["losses"], "fleet_view": observed, "quota": quota,
        "gang": gang.summary,
        "peak_allocated_bytes": [run["peak_allocated"]
                                 for run in (ref, victim, resumed)],
        "child_s": {run: record["preempt"][run]["child_s"]
                    for run in record["preempt"]}}
    log(json.dumps(summary))
    members = record["gang"].values()
    return [sum(run["launches"][n] for run in (ref, victim, swap, resumed))
            + (sum(m["launches"] for m in members) if n == "flash_fwd"
               else 0)
            for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body=None, timeout: float = 300, on_event=None,
         context=None):
    """(status, parsed body) of a GET, or of a POST of ``body`` as JSON;
    a server-sent-events reply becomes its list of events (``on_event``
    is called as each arrives).  ``context``: an ``ssl.SSLContext`` for
    an https URL."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=context) as r:
            kind = r.headers.get("Content-Type", "")
            if kind == "text/event-stream":
                events = []
                for raw in r:
                    line = raw.decode().strip()
                    if line.startswith("data: "):
                        events.append((time.monotonic(),
                                       json.loads(line[len("data: "):])))
                        if on_event is not None:
                            on_event()
                return r.status, events
            text = r.read().decode()
            return r.status, json.loads(text) if "json" in kind else text
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def parse_metrics(text: str) -> dict:
    """Prometheus text: sample name -> value; every line must parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            check(line.startswith(("# HELP ", "# TYPE ")) or not line,
                  f"/metrics line {line!r}")
            continue
        name, value = line.split(" ")
        out[name] = float(value)
    return out


def quant_fixture(model, layer: int = 0) -> dict:
    """The full-precision weights of one layer's projections as a
    Flax-layout tree of f32 numpy arrays ([in, out]), on the host."""
    from k8s_vgpu_scheduler_tpu_torch.models.convert import _projections

    tree: dict = {}
    for path, parent, name in _projections(model):
        if path[0] == f"layer_{layer}":
            w = getattr(parent, name).weight.detach().float().T
            tree.setdefault(path[1], {})[name] = {
                "kernel": w.contiguous().cpu().numpy()}
    return tree


def same_quant_bytes(quant, model, tree: dict, bits: int) -> bool:
    """The card's quantized layer-0 buffers against quantize_params of the
    same f32 values on the host."""
    import numpy as np

    want = quant.quantize_params(tree, bits)
    key = "kernel_q" if bits == 8 else "kernel_q4"
    layer = model.layers[0]
    return all(
        np.array_equal(getattr(getattr(mod, name), key).cpu().numpy(),
                       leaf[key])
        and np.array_equal(getattr(mod, name).scale.cpu().numpy(),
                           leaf["scale"])
        for group, mod in (("attn", layer.attn), ("mlp", layer.mlp))
        for name, leaf in want[group].items())


def fidelity(torch, got, want) -> dict:
    """Cosine and top-1 agreement of two logits tensors (f32 on the
    card)."""
    a, b = got.float().reshape(-1), want.float().reshape(-1)
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return dict(cosine=cos, top1_agreement=top1)


def reference_tokens(serve, model, prompts) -> dict:
    """The six requests through an in-process 4-slot engine, one after
    another: the pod's expected tokens."""
    eng = serve.ServingEngine(model, max_slots=SERVE_SLOTS,
                              max_len=max(SERVE_LENS) + SERVE_NEW)
    tokens, ttft = [], []
    t0 = time.monotonic()
    for p in prompts:
        eng.submit(p, SERVE_NEW)
        (c,) = eng.run()
        tokens.append(c.tokens)
        ttft.append(c.ttft_s)
    decode_tokens = eng.stats["tokens_out"] - eng.stats["prefills"]
    return dict(tokens=tokens, wall_s=time.monotonic() - t0,
                ttft_p50_s=serve.nearest_rank(ttft, 0.5),
                ttft_max_s=max(ttft),
                decode_tokens_per_s=decode_tokens
                / eng.stats["decode_seconds"])


def trace_summary(reply) -> dict:
    """A /profilez reply's trace: its CUDA kernel events, its events by
    category and the span of its kernels."""
    trace = json.loads((Path(reply[1]["trace_dir"]) / "trace.json")
                       .read_text())
    cats: dict = {}
    kernels = []
    for e in trace["traceEvents"]:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        if e.get("cat") == "kernel":
            kernels.append(e)
    span_us = (max(e["ts"] + e.get("dur", 0) for e in kernels)
               - min(e["ts"] for e in kernels)) if kernels else 0.0
    return dict(kernels=len(kernels), kernel_span_s=span_us / 1e6,
                events_by_cat=cats)


def run_pod_serve(quant: str, config: Path, ckpt: Path, tmp: Path, uuid,
                  vgpu: Path, interposer: Path, prompts, want,
                  out: dict) -> None:
    """The serving pod as a pod runs it: ``python -m
    k8s_vgpu_scheduler_tpu_torch.cmd.serve`` through the interposer under
    QUANT_GRANT_MIB[quant].  Once /healthz answers, six clients post the
    six requests at once (the first streams) while /healthz, /statsz and
    /metrics are read, and /profilez once the streamed request's first
    token has come: the pod's first trace, in its decode (the pod started
    the tracer, and charged it, before loading its model).  Then one
    blocking request and SIGTERM.  From the pod's start to its exit
    smi_card_mib reads the card (less what it held before) and the region
    the pod's charge: every reading is held to the grant.  Readings go
    into ``out`` as they come."""
    import signal

    from k8s_vgpu_scheduler_tpu_torch.cmd.serve import TRACER_MIB
    from k8s_vgpu_scheduler_tpu_torch.monitor import RegionReader

    grant = QUANT_GRANT_MIB[quant]
    label = f"serve_{quant}"
    region_file = tmp / label / "cudevshr.cache"
    (tmp / label / "prof").mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith(GRANT_ENV)}
    env.update(LD_PRELOAD=str(interposer), NVIDIA_VISIBLE_DEVICES=uuid,
               CUDA_DEVICE_MEMORY_LIMIT_0=f"{grant}m",
               CUDA_DEVICE_MEMORY_SHARED_CACHE=str(region_file),
               VTPU_PROFILE_BASE=str(tmp / label / "prof"))
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    baseline = smi_card_mib()
    reader = RegionReader(str(vgpu))
    samples, stop = [], threading.Event()  # (t, card MiB, charged MiB)

    def watch():
        region = None
        try:
            while not stop.is_set():
                if region is None and region_file.exists():
                    region = reader.open(str(region_file))
                charged = region.used(0) / MIB if region else None
                samples.append((time.monotonic(), smi_card_mib() - baseline,
                                charged))
                if samples[-1][1] > grant and "over_grant" not in out:
                    # Whose memory: the card's processes at the first
                    # reading past the grant (the pod is proc.pid).
                    out["over_grant"] = dict(
                        t_s=samples[-1][0] - t0, mib=samples[-1][1],
                        pod_pid=proc.pid, parent_pid=os.getpid(),
                        apps=smi_rows("--query-compute-apps=pid,"
                                      "used_memory"))
                stop.wait(0.1)
        finally:
            if region is not None:
                region.close()

    got, surfaces, decoding, traced = {}, {}, threading.Event(), []

    def client(i):
        req = {"prompt": prompts[i], "max_new_tokens": SERVE_NEW}
        sent = time.monotonic()
        if i == 0:
            status, events = http(url + "/v1/generate", dict(req, stream=True),
                                  on_event=decoding.set)
            got[i] = (status, [e["token"] for _, e in events if "token" in e],
                      events[0][0] - sent if events else None)
        else:
            status, body = http(url + "/v1/generate", req)
            got[i] = (status, body.get("tokens")
                      if isinstance(body, dict) else body, None)

    def read_surfaces():
        for name in ("healthz", "statsz", "metrics"):
            surfaces[name] = http(f"{url}/{name}")
        decoding.wait(300)
        traced.append(time.monotonic())
        surfaces["profilez"] = http(f"{url}/profilez?seconds={PROFILE_S}")

    t0 = time.monotonic()
    with open(logs / f"{label}.log", "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_vgpu_scheduler_tpu_torch.cmd.serve",
             "--config", str(config), "--checkpoint", str(ckpt), "--quant",
             quant, "--max-slots", str(SERVE_SLOTS), "--max-len",
             str(max(SERVE_LENS) + SERVE_NEW), "--bind", f"127.0.0.1:{port}"],
            env=env, cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            while True:
                check(proc.poll() is None, f"the {quant} pod exited "
                      f"{proc.returncode} before serving (see {label}.log)")
                check(time.monotonic() - t0 < 600,
                      f"the {quant} pod did not come up in 600 s")
                try:
                    if http(url + "/healthz", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            out["ready_s"] = time.monotonic() - t0
            start = time.monotonic()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            threads.append(threading.Thread(target=read_surfaces))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                check(not t.is_alive(), f"the {quant} pod's wave hung")
            out["wave_s"] = time.monotonic() - start
            check(proc.poll() is None, f"the {quant} pod exited "
                  f"{proc.returncode} during its wave (see {label}.log)")
            _, again = http(url + "/v1/generate",
                            {"prompt": prompts[0],
                             "max_new_tokens": SERVE_NEW})
            _, stats = http(url + "/statsz")
            _, metrics = http(url + "/metrics")
            sigterm = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            out["sigterm_to_exit_s"] = time.monotonic() - sigterm
        finally:
            stop.set()
            watcher.join()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cap_t, traced = traced[0], surfaces["profilez"]
    before = [mib for t, mib, _ in samples if t < cap_t]
    during = [mib for t, mib, _ in samples if cap_t <= t < sigterm]
    peak = max(mib for _, mib, _ in samples)
    out.update(grant_mib=grant, smi_baseline_mib=baseline, smi_peak_mib=peak,
               charged_peak_mib=max(c for _, _, c in samples
                                    if c is not None),
               memory_timeline=[(t - t0, mib, charged)
                                for t, mib, charged in samples],
               profilez_s=cap_t - t0, profilez_status=traced[0],
               profilez_reply=traced[1], tracer_charge_mib=TRACER_MIB,
               smi_rise_from_profilez_mib=max(during) - before[-1])
    if traced[0] == 200:
        out["trace"] = trace_summary(traced)
    if isinstance(stats, dict):
        lat = stats["latency"]
        decode_tokens = (stats["stats"]["tokens_out"]
                         - stats["stats"]["prefills"])
        out.update(stream_ttft_s=got[0][2] if 0 in got else None,
                   ttft_p50_s=lat["ttft_s"]["p50"],
                   ttft_max_s=lat["ttft_s"]["p95"],  # nearest-rank p95 of 7
                   decode_tokens_per_s=decode_tokens
                   / stats["stats"]["decode_seconds"],
                   pool_bytes=stats["pool_hbm_bytes"])
    log_text = (logs / f"{label}.log").read_text()
    (logs / f"{label}_memory.json").write_text(json.dumps(
        {k: out.get(k) for k in ("grant_mib", "smi_baseline_mib",
                                 "smi_peak_mib", "over_grant",
                                 "memory_timeline")}))
    check(peak <= grant, f"the {quant} pod peaked at {peak} MiB on the "
          f"card, grant {grant} MiB (see {label}_memory.json)")
    check(rc == 0 and "drain complete" in log_text,
          f"the {quant} pod exited {rc} after SIGTERM (see {label}.log)")
    check(all(got[i][0] == 200 for i in got),
          f"{quant} pod statuses {[got[i][0] for i in sorted(got)]}")
    check(all(surfaces[n][0] == 200 for n in ("healthz", "statsz",
                                               "metrics")),
          f"{quant} pod surfaces {[(n, surfaces[n][0]) for n in surfaces]}")
    tokens = [got[i][1] for i in range(len(prompts))]
    rows = [i for i in range(len(prompts)) if tokens[i] != want[i]]
    check(not rows, f"the {quant} pod's tokens differ from the in-process "
          f"engine's in requests {rows}")
    check(again["tokens"] == tokens[0], "streamed tokens != blocking ones")
    prom = parse_metrics(metrics)
    out["metrics_samples"] = len(prom)
    check(prom["vtpu_serve_completions_total"] == len(prompts) + 1,
          f"/metrics completions {prom.get('vtpu_serve_completions_total')}")
    check(traced[0] == 200 and out["trace"]["kernels"] > 0,
          f"the {quant} pod's /profilez: {traced[0]} "
          f"{out.get('trace', traced[1])}")


def phase_quant_serve(torch, port, record, vgpu: Path, interposer: Path):
    """The serving pod's life on the card: the seeded 32-layer bf16
    llama_7b written with save_checkpoint; its bf16, int8 (quantized in
    place on the card) and int4 (restored to the host, quantized on the
    way up) logits on a (1, QUANT_PROMPT) prompt through the flash
    kernel; the card's layer-0 bytes against quantize_params on the host;
    the six requests through an in-process engine of each precision, one
    after another; then the pod itself (run_pod_serve) as int8 under
    8000 MiB and int4 under 5000 MiB, each held to its in-process tokens;
    and QuantLinear4 against the JAX form of its product, written here
    (int4_vs_group_sums), on 2 layers.  Returns the forward kernel's
    launches."""
    llama, convert, _, serve, _ = port
    from k8s_vgpu_scheduler_tpu_torch.models import checkpoint, quant
    from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as fa

    uuid = nvidia_smi("uuid")
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama_7b()
    fcfg = dataclasses.replace(cfg, attention="flash")
    res = record["quant_serve"] = {"card": record["card"]}
    fa.flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        tmp = Path(tmp)
        ckpt = tmp / "llama_7b"
        config = tmp / "llama_7b.json"
        config.write_text(json.dumps(dataclasses.asdict(cfg)))
        model = convert.init_weights(
            fcfg, torch.Generator(device="cuda").manual_seed(SEED + 1))
        t0 = time.monotonic()
        checkpoint.save_checkpoint(str(ckpt), 0, model)
        res["save_s"] = time.monotonic() - t0
        res["checkpoint_bytes"] = os.path.getsize(ckpt / "0" / "state.pt")
        prompt = torch.randint(0, cfg.vocab, (1, QUANT_PROMPT), device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED + 7))
        prompts = serve_prompts(torch, cfg)
        bf16 = model(prompt).float()
        tree = quant_fixture(model)
        t0 = time.monotonic()
        convert.quantize_model(model, 8)
        torch.cuda.synchronize()
        res["int8_quantize_on_card_s"] = time.monotonic() - t0
        check(same_quant_bytes(quant, model, tree, 8),
              "int8 bytes on the card != quantize_params on the host")
        res["int8"] = fidelity(torch, model(prompt), bf16)
        check(res["int8"]["cosine"] > MIN_INT8_COSINE,
              f"int8 logits' cosine {res['int8']['cosine']} to bf16")
        ref8 = reference_tokens(serve, model, prompts)
        res["int8"]["in_process"] = {k: v for k, v in ref8.items()
                                     if k != "tokens"}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        run_pod_serve("int8", config, ckpt, tmp, uuid, vgpu, interposer,
                      prompts, ref8["tokens"], res["int8"].setdefault(
                          "pod", {}))
        host = llama.Llama(fcfg, device="cpu")
        t0 = time.monotonic()
        checkpoint.restore_checkpoint(str(ckpt), host, device="cpu")
        res["restore_to_host_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        model = convert.quantize_model(host, 4)
        torch.cuda.synchronize()
        res["int4_quantize_on_the_way_up_s"] = time.monotonic() - t0
        del host
        check(same_quant_bytes(quant, model, tree, 4),
              "int4 bytes on the card != quantize_params on the host")
        res["int4"] = fidelity(torch, model(prompt), bf16)
        ref4 = reference_tokens(serve, model, prompts)
        res["int4"]["in_process"] = {k: v for k, v in ref4.items()
                                     if k != "tokens"}
        res["int4"]["model_bytes"] = sum(
            t.numel() * t.element_size() for t in model.state_dict().values())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        run_pod_serve("int4", config, ckpt, tmp, uuid, vgpu, interposer,
                      prompts, ref4["tokens"], res["int4"].setdefault(
                          "pod", {}))
        shutil.rmtree(ckpt)
        res["int4_vs_group_sums"] = int4_vs_group_sums(
            torch, convert, fcfg, prompt)
    launches = fa.flash_attention.launches
    want = 3 * cfg.n_layers + 3 * 2
    check(launches == want, f"flash launches {launches} in the quantized "
          f"path, want {want}")
    sums = res["int4_vs_group_sums"]
    check(sums["rel_rms"] <= TOL_INT4_VS_GROUP_SUMS
          < sums["control"]["rel_rms"],
          f"QuantLinear4 vs the per-group sums: {sums}, limit "
          f"{TOL_INT4_VS_GROUP_SUMS}")
    res["seconds"] = time.monotonic() - t_phase
    res["flash_launches"] = launches
    log(json.dumps({"phase": "quant_serve", **res}))
    return launches


class SmiWatch:
    """nvidia-smi's reading of the card, less what it held on entry, every
    SMI_EVERY_S in a thread from entry to exit: (time, MiB) samples."""

    def __enter__(self) -> "SmiWatch":
        self.baseline = smi_card_mib()
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.is_set():
            self.samples.append((time.monotonic(),
                                 smi_card_mib() - self.baseline))
            self._stop.wait(SMI_EVERY_S)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def phase_workloads(torch, record, interposer: Path):
    """The reference's ten benchmark cases on the card: the bare leg
    (child_workloads_bare: no interposer, nvidia-smi read through each
    case from the parent) and then each case as a pod
    (child_workload_pod) through the interposer under its grant, alone on
    the card and read by nvidia-smi from its go to its exit.  Checks each
    pod: it ran with no refusal, every nvidia-smi reading within its
    grant, the region's ``used`` within TOL_USED of nvidia-smi's reading,
    no launch gated, its output within the bare leg's bound of the f32
    path.  Records images/s in both legs and their ratio, the peaks,
    FLOPs and MFU against the bf16 peak, and the V100 baseline ratio."""
    from k8s_vgpu_scheduler_tpu_torch.models import workloads as wl

    uuid = nvidia_smi("uuid")
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    marks: dict = {}

    def mark(line: str) -> None:
        if line.startswith("WORKLOAD_CASE "):
            _, which, name = line.split()
            marks[(which, name)] = time.monotonic()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        refs = tmp / "refs"
        refs.mkdir()
        bare = EnforceChild("workloads_bare", tmp, WORKLOAD_REFS=refs)
        pods = {name: EnforceChild(
            f"workload:{name}", tmp, label=name, WORKLOAD_REFS=refs,
            LD_PRELOAD=interposer, NVIDIA_VISIBLE_DEVICES=uuid,
            CUDA_DEVICE_MEMORY_LIMIT_0=f"{case.grant_mib}m")
            for name, case in wl.CASES.items()}
        try:
            for child in (bare, *pods.values()):  # no imports beside a run
                child.wait_ready()
            with SmiWatch() as watch:
                cases = bare.run(record, "workloads", on_line=mark)["cases"]
            peaks = {name: max([cases[name]["smi_mib"]] + [
                mib for t, mib in watch.samples
                if marks[("begin", name)] <= t <= marks[("end", name)]])
                for name in wl.CASES}
            runs, smi = {}, {}
            for name, child in pods.items():
                with SmiWatch() as watch:
                    runs[name] = child.run(record, "workloads")
                smi[name] = [mib for _, mib in watch.samples] + [
                    runs[name]["smi_mib"]]
        finally:
            for child in (bare, *pods.values()):
                child.stop()
    rows = []
    for name, case in wl.CASES.items():
        b, p = cases[name], runs[name]
        stats = p["interposer"]
        check(stats["refusals"] == 0, f"{name}: the pod was refused "
              f"{stats['refusals']} times")
        check(max(smi[name]) <= case.grant_mib, f"{name}: the pod read "
              f"{max(smi[name])} MiB by nvidia-smi, grant {case.grant_mib}")
        check(abs(p["region_used"] - p["smi_mib"] * MIB)
              <= TOL_USED * p["smi_mib"] * MIB,
              f"{name}: region used {p['region_used']} against "
              f"nvidia-smi's {p['smi_mib']} MiB")
        check(stats["gated"] == 0, f"{name}: {stats['gated']} launches "
              "gated with no compute limit")
        flops = b["flops_per_step"]
        mfu = {leg: flops * case.iters / r["seconds"] / PEAK_FLOPS["bfloat16"]
               for leg, r in (("bare", b), ("pod", p))}
        rows.append(dict(
            case=name, model=case.model, batch=case.batch, size=case.size,
            iters=case.iters, train=case.train, grant_mib=case.grant_mib,
            grant_rule_mib=wl.grant_for(peaks[name]),
            bare_images_per_s=b["images_per_s"],
            pod_images_per_s=p["images_per_s"],
            pod_over_bare=p["images_per_s"] / b["images_per_s"],
            bare_windows=b["windows"], pod_windows=p["windows"],
            bare_smi_peak_mib=peaks[name], pod_smi_peak_mib=max(smi[name]),
            pod_smi_mib_held=p["smi_mib"],
            pod_region_used_mib=p["region_used"] / MIB,
            pod_context_charged_mib=stats["context_bytes"] / MIB,
            pod_footprint_mib=p["smi_mib"] - stats["alloc_bytes"] / MIB,
            bare_reserved_peak_mib=b["reserved_peak"] / MIB,
            pod_reserved_peak_mib=p["reserved_peak"] / MIB,
            bf16_vs_f32=b["bf16_vs_f32"], pod_bf16_vs_f32=p["bf16_vs_f32"],
            pod_same_as_bare=p["same_as_bare"],
            bound=TOL_WORKLOAD[name], flops_per_step=flops,
            flops_source="analytic" if case.model == "lstm"
            else "FlopCounterMode",
            bare_mfu=mfu["bare"], pod_mfu=mfu["pod"],
            v100_vgpu_tf24_images_per_s=case.baseline,
            pod_vs_v100_baseline=p["images_per_s"] / case.baseline,
            pod_launches_per_step=p["launches_per_step"],
            pod_child_s=p["child_s"]))
    summary = {
        "phase": "workloads", "card": record["card"],
        "seconds": time.monotonic() - t0,
        "settings": "cudnn.benchmark off, no TF32; pods: interposer, "
                    "memory grant only",
        "mfu_peak_tflops": PEAK_FLOPS["bfloat16"] / 1e12,
        "profiles": {name: dict(
            cases[name]["profile"],
            busy_share_of_timed_step=cases[name]["profile"]["device_busy_ms"]
            / (1e3 * cases[name]["seconds"] / wl.CASES[name].iters))
            for name in WORKLOAD_PROFILED},
        "bare_child_s": record["workloads"]["workloads_bare"]["child_s"]}
    record["workloads_summary"] = dict(summary, rows=rows, losses={
        name: {"bare": cases[name]["losses"], "pod": runs[name]["losses"]}
        for name in wl.CASES if wl.CASES[name].train})
    record["workloads_s"] = summary["seconds"]
    log(json.dumps(summary))
    log(json.dumps({"workloads": rows}))


def int4_vs_group_sums(torch, convert, cfg, prompt) -> dict:
    """2 layers at llama_7b widths: the int4 model's (1, QUANT_PROMPT)
    logits against the same model whose projections are the JAX
    package's QuantDense4 written here in plain torch (a partial product
    per 128-row group, scaled, then summed) over weights unpacked here
    from the model's bytes on the host, apart from quant.py; and against a
    control whose unpacking swaps the two nibbles of a byte.  Relative
    RMS and max error of each."""
    import numpy as np

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = convert.init_weights(
        cfg2, torch.Generator(device="cuda").manual_seed(SEED + 8))
    convert.quantize_model(model, 4)
    got = model(prompt).float()

    class GroupSums(torch.nn.Module):
        def __init__(self, packed, scale, dtype, swap: bool):
            super().__init__()
            b = packed.cpu().numpy()
            lo = (b & 0xF).astype(np.int8) - 8   # row 2i, offset by 8
            hi = (b >> 4).astype(np.int8) - 8    # row 2i + 1
            if swap:
                lo, hi = hi, lo
            w = np.empty((2 * b.shape[0], b.shape[1]), np.int8)
            w[0::2], w[1::2] = lo, hi
            self.w = torch.from_numpy(w).to(scale.device)
            self.scale, self.dtype = scale, dtype

        def forward(self, x):
            (groups, out), n_in = self.scale.shape, self.w.shape[0]
            xg = x.to(self.dtype).reshape(*x.shape[:-1], groups,
                                          n_in // groups)
            wg = self.w.to(self.dtype).reshape(groups, n_in // groups, out)
            y = torch.einsum("...gi,gif->...gf", xg, wg)
            return (y * self.scale.to(self.dtype)).sum(-2).to(self.dtype)

    def error(swap: bool) -> dict:
        kept = [(parent, name, getattr(parent, name))
                for _, parent, name in convert._projections(model)]
        for parent, name, mod in kept:
            setattr(parent, name, GroupSums(mod.kernel_q4, mod.scale,
                                            mod.dtype, swap))
        try:
            want = model(prompt).float()
        finally:
            for parent, name, mod in kept:
                setattr(parent, name, mod)
        return dict(rel_rms=float((got - want).norm() / want.norm()),
                    max_err_over_max=float((got - want).abs().max()
                                           / want.abs().max()))

    return dict(error(swap=False), control=error(swap=True))


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound, library_ms, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, **extra)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--enforce-child":
        if sys.argv[2] == "node_agent":  # before torch is imported
            return node_agent()
        if sys.argv[2] == "control_plane":
            return control_plane()
        if sys.argv[2] == "mock_agent":
            return mock_agent()
        return enforce_child(sys.argv[2])
    t_script = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.entry import entry
    from k8s_vgpu_scheduler_tpu_torch.models import (
        convert, generate, llama, serve, train)
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as fa

    # The plain versions are the f32 reference: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "card_used_mib": dict(
                  nvidia_smi=int(smi_rows("--query-gpu=memory.used")[0][0]),
                  window=smi_card_mib())}
    log("the card's used MiB by nvidia-smi and by a window of NVML:",
        record["card_used_mib"])
    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        # build_all is what the image's build stage runs: the kernels, the
        # enforcement library and the interposer, all started together.
        driver = pool.submit(_kernels.build_interposer_test)
        built = _kernels.build_all()
        driver = driver.result()
    vgpu, interposer = built["vgpu"], built["interposer"]
    record["build_s"] = time.monotonic() - t0
    log(f"built {', '.join(KERNEL_SOURCES)} in {record['build_s']:.1f} s")
    record["ptxas"] = {name: _kernels.build_logs.get(name, "")
                       for name in KERNEL_SOURCES}
    for name in KERNEL_SOURCES:
        log(record["ptxas"][name].strip())
    record["registers"] = [row for name in KERNEL_SOURCES
                           for row in ptxas_kernels(record["ptxas"][name])]
    log("registers", json.dumps(record["registers"]))

    port = (llama, convert, generate, serve, train)
    try:
        check(set(built) == {*KERNEL_SOURCES, "vgpu", "interposer"},
              f"build_all built {sorted(built)}")
        # The tensor-core kernels keep every value in registers.
        mma = [r for r in record["registers"] if "mma" in r["kernel"]]
        check(len(mma) == 3 * len(fa._HEAD_DIMS)
              and all(r["spill_bytes"] == 0 for r in mma),
              f"tensor-core kernels spill or are missing: {mma}")
        forward, (model, tokens) = entry()
        logits = forward(model, tokens)
        check(logits.shape == (2, 32, 256)
              and bool(torch.isfinite(logits.float()).all()),
              "entry() logits")
        phase_kernel(torch, fa, record)
        phase_backward_kernels(torch, fa, record)
        phase_forward_and_serve_f32(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        phase_forward_bf16(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches = phase_main_path(torch, fa, port, record)
        gc.collect()
        torch.cuda.empty_cache()  # the 32-layer serving model is gone
        phase_train_f32_parity(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        train_launches = phase_train_main(torch, fa, port, record)
        enforce_launches = phase_enforce(torch, record, interposer, driver)
        cores_launches = phase_coresidency(torch, record, vgpu, interposer)
        plugin_launches = phase_device_plugin(torch, record, vgpu)
        preempt_launches = phase_preempt(torch, record, vgpu, interposer)
        quant_launches = phase_quant_serve(torch, port, record, vgpu,
                                           interposer)
        phase_workloads(torch, record, interposer)
    except Fail as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    t = record["flash_fwd_timing"]
    b = record["flash_bwd_timing"]
    src = "k8s_vgpu_scheduler_tpu_torch/csrc/"
    tpu = "k8s_vgpu_scheduler_tpu/ops/flash_attention.py:"
    kernels = [
        kernel_row("flash_fwd", src + "flash_fwd.cu", tpu + "57",
                   serve_launches + train_launches[0] + enforce_launches[0]
                   + cores_launches[0] + plugin_launches[0]
                   + preempt_launches[0] + quant_launches,
                   t["max_abs_err"],
                   t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]),
                   t["library_ms"],
                   launches_by_path={"serve": serve_launches,
                                     "train": train_launches[0],
                                     "enforce": enforce_launches[0],
                                     "coresidency": cores_launches[0],
                                     "device_plugin": plugin_launches[0],
                                     "preempt": preempt_launches[0],
                                     "quant": quant_launches},
                   kernel="flash_fwd_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_fwd_kernel (scalar f32)",
                   f32_ms=t["f32_ms"], errors=t["errors"]),
        kernel_row("flash_bwd_dq", src + "flash_bwd.cu", tpu + "172",
                   train_launches[1] + enforce_launches[1]
                   + cores_launches[1] + plugin_launches[1]
                   + preempt_launches[1],
                   b["errors"]["dq"]["max_abs_err"],
                   b["dq_ms"], b["plain_dq_ms"],
                   (b["dq_bound_ms"], b["dq_bound_by"]), b["library_ms"],
                   launches_by_path={"train": train_launches[1],
                                     "enforce": enforce_launches[1],
                                     "coresidency": cores_launches[1],
                                     "device_plugin": plugin_launches[1],
                                     "preempt": preempt_launches[1]},
                   library_covers="dq, dk and dv",
                   kernel="flash_bwd_dq_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_bwd_dq_kernel (scalar f32)",
                   f32_ms=b["dq_f32_ms"], errors={"dq": b["errors"]["dq"]}),
        kernel_row("flash_bwd_dkv", src + "flash_bwd.cu", tpu + "213",
                   train_launches[2] + enforce_launches[2]
                   + cores_launches[2] + plugin_launches[2]
                   + preempt_launches[2],
                   max(b["errors"][n]["max_abs_err"] for n in ("dk", "dv")),
                   b["dkv_ms"], b["plain_dkv_ms"],
                   (b["dkv_bound_ms"], b["dkv_bound_by"]), b["library_ms"],
                   launches_by_path={"train": train_launches[2],
                                     "enforce": enforce_launches[2],
                                     "coresidency": cores_launches[2],
                                     "device_plugin": plugin_launches[2],
                                     "preempt": preempt_launches[2]},
                   library_covers="dq, dk and dv",
                   kernel="flash_bwd_dkv_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_bwd_dkv_kernel (scalar f32)",
                   f32_ms=b["dkv_f32_ms"],
                   errors={n: b["errors"][n] for n in ("dk", "dv")}),
    ]
    record["kernels"] = kernels
    record["card_transients"] = [(t - t_script, least, most)
                                 for t, least, most in CARD_TRANSIENTS]
    log("card transients (s, least MiB, highest MiB):",
        json.dumps(record["card_transients"]))
    record["script_s"] = time.monotonic() - t_script
    record["phase_s"] = {k: record.get(k) for k in (
        "build_s", "enforce_s", "coresidency_s", "device_plugin_s")} | {
        "preempt_s": record["preempt_summary"]["seconds"],
        "quant_serve_s": record["quant_serve"]["seconds"],
        "workloads_s": record["workloads_s"]}
    log(json.dumps({"phase_s": record["phase_s"],
                    "script_s": record["script_s"]}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
