"""Continuous batching: a slot-pool serving engine for the port's decoder.

Port of the JAX package's models/serve.py ``ServingEngine``: ``max_slots``
sequences x ``max_len`` cache rows allocated once; requests are admitted
into free slots (prefill right-padded to a power-of-two bucket, written
straight into that slot's pool rows) and retired out of them, while one
lock-step decode step advances every slot.  Eager PyTorch: the decode
step runs ``horizon`` forwards per dispatch without a CUDA graph.

Greedy outputs match :func:`.generate.generate` per request, whatever
the arrival order or slot contention (token-exact in f32; in bf16 a
one-ULP logit difference between the two shape-variant computations can
flip argmax at a near-tie).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..shim.core import gated
from .generate import _sample
from .llama import LayerCache, Llama, PAD_POSITION, torch_dtype


def nearest_rank(xs, q: float) -> float:
    """Nearest-rank percentile on a non-empty sequence."""
    s = sorted(xs)
    return s[min(int(q * len(s)), len(s) - 1)]


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    produced: int
    tokens: List[int]
    t_submit: float = 0.0      # monotonic, stamped by submit()
    t_first: float = 0.0       # first token on the host (prefill return)


@dataclasses.dataclass
class Completion:
    request_id: int
    prompt: List[int]
    tokens: List[int]          # generated tokens (including eos if hit)
    finished_by: str           # "eos" | "length"
    ttft_s: float = 0.0        # submit -> first token on the host
    total_s: float = 0.0       # submit -> completion observed


class ServingEngine:
    """Slot-pool continuous-batching engine on the model's device.

    Parameters
    ----------
    model : a :class:`Llama` (its device is the engine's).
    max_slots : concurrent sequences (the pool batch dimension).
    max_len : cache rows per slot; a request needs
        ``len(prompt) + max_new_tokens <= max_len``.
    eos_id : optional stop token.
    temperature : 0 = greedy; > 0 samples from ``generator``.
    horizon : decode steps per dispatch; greedy output is identical for
        any horizon (overshoot past EOS/length is discarded host-side).
    """

    def __init__(self, model: Llama, *, max_slots: int, max_len: int,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, horizon: int = 1,
                 generator: Optional[torch.Generator] = None):
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling requires a generator")
        if max_slots < 1 or max_len < 1:
            raise ValueError("max_slots and max_len must be >= 1")
        if horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.S = int(max_slots)
        self.L = int(max_len)
        self.eos_id = eos_id
        self.horizon = int(horizon)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.generator = generator
        self.cache: List[LayerCache] = model.new_cache(self.S, self.L)
        self.key_pos = torch.full((self.S, self.L), PAD_POSITION,
                                  dtype=torch.long, device=self.device)
        # Small per-slot state lives host-side (numpy): admission control
        # is host logic anyway.
        self.lengths = np.zeros(self.S, np.int64)   # rows written per slot
        self.cur = np.zeros(self.S, np.int64)       # sampled, not yet cached
        self.active = np.zeros(self.S, bool)
        self.slots: Dict[int, _Slot] = {}
        self.queue: List[dict] = []
        self._next_id = 0
        self._completed: List[Completion] = []
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "decode_dispatches": 0, "tokens_out": 0,
                      "completions": 0, "cancelled": 0,
                      "decode_seconds": 0.0}
        # Bounded reservoirs of client-observed latencies; readers on
        # other threads take the lock.
        self._lat_ttft = deque(maxlen=512)
        self._lat_per_token = deque(maxlen=512)
        self._lat_lock = threading.Lock()

    # -- capacity ---------------------------------------------------------

    def pool_hbm_bytes(self) -> int:
        """Closed-form KV pool footprint in device memory."""
        itemsize = torch.empty((), dtype=torch_dtype(self.cfg)).element_size()
        per_layer = 2 * self.S * self.L * self.cfg.n_kv_heads \
            * self.cfg.head_dim * itemsize
        return per_layer * self.cfg.n_layers

    # -- request intake ---------------------------------------------------

    def validate_request(self, prompt, max_new_tokens: int) -> list:
        """Coerce + bounds-check a request without touching engine
        state."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.L:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_len {self.L}")
        return prompt

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or running request; no Completion is emitted.
        False when the id is unknown."""
        for i, req in enumerate(self.queue):
            if req["id"] == request_id:
                del self.queue[i]
                self.stats["cancelled"] += 1
                return True
        for slot, st in self.slots.items():
            if st.request_id == request_id:
                self.active[slot] = False
                del self.slots[slot]
                self.stats["cancelled"] += 1
                return True
        return False

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = self.validate_request(prompt, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self.queue.append({"id": rid, "prompt": prompt,
                           "max_new_tokens": int(max_new_tokens),
                           "t_submit": time.monotonic()})
        return rid

    # -- device paths -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.L)

    def _sample(self, logits):
        return _sample(logits, self.temperature, self.generator,
                       self.top_k, self.top_p)

    @gated
    def _prefill(self, prompt: List[int], slot: int) -> int:
        """Prefill one slot's rows (a B=1 view of the pool written at
        index 0; pads included — their sentinel key positions keep them
        masked until decode overwrites them).  Returns the first token."""
        plen = len(prompt)
        P = self._bucket(plen)
        dev = self.device
        toks = torch.zeros((1, P), dtype=torch.long)
        toks[0, :plen] = torch.tensor(prompt)
        ar = torch.arange(P, device=dev)
        positions = torch.clamp(ar, max=plen - 1)[None]
        row = torch.full((self.L,), PAD_POSITION, dtype=torch.long,
                         device=dev)
        row[:P] = torch.where(ar < plen, ar,
                              torch.full((), PAD_POSITION, device=dev))
        sub = [LayerCache(c.k[slot:slot + 1], c.v[slot:slot + 1], c.idx)
               for c in self.cache]
        logits = self.model(toks.to(dev), positions, row[None],
                            torch.zeros((1,), dtype=torch.long, device=dev),
                            cache=sub)
        self.key_pos[slot] = row
        return int(self._sample(logits[0, plen - 1]))

    @gated
    def _decode(self) -> np.ndarray:
        """``horizon`` lock-step decode steps over every slot; returns the
        sampled tokens [horizon, S]."""
        dev, S, L = self.device, self.S, self.L
        rows = torch.arange(S, device=dev)
        active = torch.as_tensor(self.active, device=dev)
        act = active.long()
        lengths = torch.as_tensor(self.lengths, device=dev)
        cur = torch.as_tensor(self.cur, device=dev)
        out = []
        for _ in range(self.horizon):
            # Clamp covers rows that finished host-side mid-horizon: their
            # write lands in their own row, never a neighbour's.
            wi = torch.clamp(torch.where(active, lengths, 0), max=L - 1)
            # Stamp this step's position before the forward: each row's
            # new key must be attendable by its own query.
            self.key_pos[rows, wi] = torch.where(
                active, lengths, self.key_pos[rows, wi])
            logits = self.model(cur[:, None], wi[:, None], self.key_pos, wi,
                                cache=self.cache)
            tok = self._sample(logits[:, -1])
            lengths = lengths + act
            cur = torch.where(active, tok, cur)
            out.append(tok)
        return torch.stack(out).cpu().numpy()

    # -- engine loop ------------------------------------------------------

    def _admit(self) -> None:
        while self.queue and not self.active.all():
            req = self.queue.pop(0)
            slot = int(np.flatnonzero(~self.active)[0])
            # int() of the sampled token synchronises: an honest TTFT.
            first = self._prefill(req["prompt"], slot)
            self.lengths[slot] = len(req["prompt"])
            self.cur[slot] = first
            self.active[slot] = True
            self.slots[slot] = _Slot(req["id"], req["prompt"],
                                     req["max_new_tokens"], 1, [first],
                                     t_submit=req.get("t_submit", 0.0),
                                     t_first=time.monotonic())
            self.stats["prefills"] += 1
            self.stats["tokens_out"] += 1
            self._finish_if_done(slot, first)

    def _finish_if_done(self, slot: int, tok: int = -1):
        st = self.slots[slot]
        done_eos = self.eos_id is not None and tok == self.eos_id
        done_len = st.produced >= st.max_new_tokens
        if done_eos or done_len:
            self.active[slot] = False
            now = time.monotonic()
            ttft = max(st.t_first - st.t_submit, 0.0) if st.t_submit else 0.0
            total = max(now - st.t_submit, 0.0) if st.t_submit else 0.0
            self._completed.append(Completion(
                st.request_id, st.prompt, st.tokens,
                "eos" if done_eos else "length",
                ttft_s=ttft, total_s=total))
            if st.t_submit:
                with self._lat_lock:
                    self._lat_ttft.append(ttft)
                    self._lat_per_token.append(
                        (total - ttft) / max(len(st.tokens) - 1, 1))
            del self.slots[slot]
            self.stats["completions"] += 1

    @torch.inference_mode()
    def step(self) -> List[Completion]:
        """Admit what fits, run ONE decode dispatch (``horizon`` steps),
        return the requests that completed during it."""
        self._completed = []
        self._admit()
        if not self.active.any():
            return self._completed
        t0 = time.monotonic()
        toks = self._decode()                    # [horizon, S], synced
        self.stats["decode_seconds"] += time.monotonic() - t0
        self.stats["decode_steps"] += self.horizon
        self.stats["decode_dispatches"] += 1
        snapshot = [int(s) for s in np.flatnonzero(self.active)]
        for t in range(self.horizon):
            for slot in snapshot:
                if not self.active[slot]:        # finished mid-horizon
                    continue
                st = self.slots[slot]
                self.lengths[slot] += 1          # cur is now in the cache
                nxt = int(toks[t, slot])
                self.cur[slot] = nxt
                st.tokens.append(nxt)
                st.produced += 1
                self.stats["tokens_out"] += 1
                self._finish_if_done(slot, tok=nxt)
        return self._completed

    def run(self) -> List[Completion]:
        """Drain queue + pool to completion; completions in finish order."""
        out: List[Completion] = []
        while self.queue or self.active.any():
            out.extend(self.step())
        return out

    @property
    def utilization(self) -> float:
        return float(self.active.sum()) / self.S

    def latency_percentiles(self) -> dict:
        """p50/p95 of client-observed TTFT and per-token latency over the
        newest completions; empty before the first completion."""
        with self._lat_lock:
            ttft = list(self._lat_ttft)
            per_tok = list(self._lat_per_token)
        if not ttft or not per_tok:
            return {}
        return {
            "n": len(ttft),
            "ttft_s": {"p50": nearest_rank(ttft, 0.50),
                       "p95": nearest_rank(ttft, 0.95)},
            "per_token_s": {"p50": nearest_rank(per_tok, 0.50),
                            "p95": nearest_rank(per_tok, 0.95)},
        }
