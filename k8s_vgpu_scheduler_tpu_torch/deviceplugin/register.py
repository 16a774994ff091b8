"""Node → scheduler registration stream.

The port's copy of the JAX package's ``deviceplugin/register.py``
(reference: pkg/device-plugin/register.go — apiDevices 410–436 applies
DeviceMemoryScaling to advertised memory; Register 438–492 opens the
DeviceService stream; WatchAndRegister 494–509 reconnects every 5 s
forever).  :func:`advertised_devices` is what the scheduler sees of each
card, as plain dicts; :func:`inventory_to_request` and
:class:`DeviceRegister` import protobuf and grpc and convert at the edge.
Each message carries the node monitor's usage counters when the register
has a ``usage_source`` (:func:`monitor_usage_source`: the monitor's
loopback NodeTPUInfo, ``vgpu-device-plugin --usage-from``), so the
scheduler's ledger is fed over the one connection the node already holds.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

from ..tpulib.backend import Backend
from ..tpulib.types import NodeInventory
from ..util.config import Config
from .partition import whole_chip_view

log = logging.getLogger(__name__)


def advertised_devices(inv: NodeInventory, cfg: Config) -> List[dict]:
    """Scaled capacity, one dict a card in ``ChipDevice``'s fields:
    deviceMemoryScaling > 1 oversubscribes memory, deviceCoresScaling > 1
    compute (register.go:422–426).  ``devmem`` is the card's advertised
    MiB (``tpulib.backend.advertised_mib`` on a node).  Only the cards of
    the whole-card view: a card with MIG on is allocated by kubelet
    passthrough, and advertising it to the extender would let the two
    paths book the same card (``partition.whole_chip_view``)."""
    return [
        dict(id=chip.uuid, count=cfg.effective_split_count(),
             devmem=int(chip.hbm_mib * cfg.device_memory_scaling),
             type=chip.type, health=chip.healthy, coords=list(chip.coords),
             cores=int(chip.cores * cfg.device_cores_scaling))
        for chip in whole_chip_view(inv).chips
    ]


def usage_to_proto(rows) -> list:
    """Sampler counter rows (accounting/sampler.py USAGE_FIELDS) → the
    register stream's ``usage`` field."""
    from ..api import device_register_pb2 as pb

    return [
        pb.UsageCounters(
            ctrkey=row["ctrkey"],
            chips=int(row["chips"]),
            active=bool(row["active"]),
            oversubscribe=bool(row["oversubscribe"]),
            chip_seconds=row["chip_seconds"],
            hbm_byte_seconds=row["hbm_byte_seconds"],
            throttled_seconds=row["throttled_seconds"],
            oversub_spill_seconds=row["oversub_spill_seconds"],
            window_s=row["window_s"],
            qos_class=row.get("qos_class", ""),
            qos_weight_pct=int(row.get("qos_weight_pct", 100)),
            qos_wait_seconds_total=row.get("qos_wait_seconds_total", 0.0),
            qos_wait_hist=[int(b) for b in row.get("qos_wait_hist", ())],
        )
        for row in rows
    ]


def monitor_usage_source(endpoint: str) -> Callable[[], List[dict]]:
    """Usage source backed by the co-located monitor's loopback
    NodeTPUInfo (``usage_only`` GetNodeTPU: counters, no region
    snapshots).

    Non-blocking: the register stream's generator thread is the lease
    heartbeat path, and a hung monitor must never delay a beat.  Each call
    returns the last cached rows at once and starts a background refresh
    (at most one in flight); counters are cumulative, so a one-beat-stale
    report loses nothing.  A failure (monitor restarting, endpoint off)
    leaves the cache as it is and the beat goes out without new usage."""
    from ..accounting.ledger import decode_usage

    lock = threading.Lock()
    state: dict = {"rows": [], "inflight": False}

    def _refresh() -> None:
        try:
            import grpc

            from ..api import noderpc_pb2 as npb
            from ..monitor.noderpc import node_tpu_stub

            with lock:
                stub = state.get("stub")
            if stub is None:
                stub = node_tpu_stub(grpc.insecure_channel(endpoint))
                with lock:
                    state["stub"] = stub
            reply = stub(npb.GetNodeTPURequest(usage_only=True), timeout=5)
            rows = decode_usage(reply.usage.counters)
            with lock:
                state["rows"] = rows
        except Exception as e:  # noqa: BLE001 — usage is best-effort
            log.debug("usage fetch from %s failed: %s", endpoint, e)
            with lock:
                state.pop("stub", None)
        finally:
            with lock:
                state["inflight"] = False

    def fetch() -> List[dict]:
        with lock:
            rows = state["rows"]
            start = not state["inflight"]
            if start:
                state["inflight"] = True
        if start:
            threading.Thread(target=_refresh, daemon=True,
                             name="usage-fetch").start()
        return rows

    return fetch


def inventory_to_request(node_name: str, inv: NodeInventory, cfg: Config,
                         usage: Optional[List[dict]] = None):
    """The register stream's message: ``advertised_devices`` (the
    whole-card view), the fabric, and ``usage``'s counter rows."""
    from ..api import device_register_pb2 as pb

    topo = pb.Topology(
        generation=inv.topology.generation,
        mesh=list(inv.topology.mesh),
        wraparound=list(inv.topology.wrap()),
    )
    req = pb.RegisterRequest(
        node=node_name,
        devices=[pb.ChipDevice(**d) for d in advertised_devices(inv, cfg)],
        topology=topo)
    if usage:
        req.usage.extend(usage_to_proto(usage))
    return req


class DeviceRegister:
    """Keeps one live Register stream to the extender; health changes push a
    fresh inventory message down the same stream."""

    def __init__(self, backend: Backend, cfg: Config,
                 endpoint: Optional[str] = None,
                 usage_source: Optional[Callable[[], List[dict]]] = None
                 ) -> None:
        self.backend = backend
        self.cfg = cfg
        self.endpoint = endpoint or cfg.scheduler_endpoint
        #: Optional provider of usage counter rows; each message carries
        #: its latest answer.
        self.usage_source = usage_source
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.connected = threading.Event()  # observable for tests/monitoring

    def push_update(self, inv: NodeInventory) -> None:
        self._q.put(inv)

    def _stream_once(self) -> None:
        import grpc

        from ..api.service import register_stub

        channel = grpc.insecure_channel(self.endpoint)
        stub = register_stub(channel)
        send_q: "queue.Queue" = queue.Queue()
        send_q.put(self.backend.inventory())

        def gen():
            while not self._stop.is_set():
                try:
                    inv = send_q.get(timeout=1.0)
                except queue.Empty:
                    # Drain externally-pushed updates into this stream.
                    try:
                        inv = self._q.get_nowait()
                    except queue.Empty:
                        continue
                if inv is None:
                    return
                usage = []
                if self.usage_source is not None:
                    try:
                        usage = self.usage_source() or []
                    except Exception as e:  # noqa: BLE001 — the beat must go out
                        log.debug("usage source failed: %s", e)
                yield inventory_to_request(self.cfg.node_name, inv,
                                           self.cfg, usage=usage)
                self.connected.set()

        try:
            future = stub.future(gen())
            # Relay pushed updates until the stream dies or we stop.
            while not self._stop.is_set() and not future.done():
                try:
                    inv = self._q.get(timeout=1.0)
                    send_q.put(inv)
                except queue.Empty:
                    continue
            if self._stop.is_set():
                send_q.put(None)
                future.result(timeout=5)
            else:
                future.result(timeout=0)  # raise the stream's error
        finally:
            self.connected.clear()
            channel.close()

    def watch_and_register(self, reconnect_delay: float = 5.0) -> None:
        while not self._stop.is_set():
            try:
                self._stream_once()
            except Exception as e:  # noqa: BLE001 — reconnect on any failure
                log.warning("register stream to %s failed: %s", self.endpoint, e)
            if not self._stop.is_set():
                self._stop.wait(reconnect_delay)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.watch_and_register, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
