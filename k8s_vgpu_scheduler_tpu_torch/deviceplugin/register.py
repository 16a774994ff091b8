"""Node → scheduler registration stream.

The port's copy of the JAX package's ``deviceplugin/register.py``
(reference: pkg/device-plugin/register.go — apiDevices 410–436 applies
DeviceMemoryScaling to advertised memory; Register 438–492 opens the
DeviceService stream; WatchAndRegister 494–509 reconnects every 5 s
forever).  :func:`advertised_devices` is what the scheduler sees of each
card, as plain dicts; :func:`inventory_to_request` and
:class:`DeviceRegister` import protobuf and grpc and convert at the edge.
The usage counters the JAX stream piggybacks wait for the port's monitor
to serve them over RPC.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import List, Optional

from ..tpulib.backend import Backend
from ..tpulib.types import NodeInventory
from ..util.config import Config

log = logging.getLogger(__name__)


def advertised_devices(inv: NodeInventory, cfg: Config) -> List[dict]:
    """Scaled capacity, one dict a card in ``ChipDevice``'s fields:
    deviceMemoryScaling > 1 oversubscribes memory, deviceCoresScaling > 1
    compute (register.go:422–426).  ``devmem`` is the card's advertised
    MiB (``tpulib.backend.advertised_mib`` on a node)."""
    return [
        dict(id=chip.uuid, count=cfg.effective_split_count(),
             devmem=int(chip.hbm_mib * cfg.device_memory_scaling),
             type=chip.type, health=chip.healthy, coords=list(chip.coords),
             cores=int(chip.cores * cfg.device_cores_scaling))
        for chip in inv.chips
    ]


def inventory_to_request(node_name: str, inv: NodeInventory, cfg: Config):
    """The register stream's message: ``advertised_devices`` and the
    fabric."""
    from ..api import device_register_pb2 as pb

    topo = pb.Topology(
        generation=inv.topology.generation,
        mesh=list(inv.topology.mesh),
        wraparound=list(inv.topology.wrap()),
    )
    return pb.RegisterRequest(
        node=node_name,
        devices=[pb.ChipDevice(**d) for d in advertised_devices(inv, cfg)],
        topology=topo)


class DeviceRegister:
    """Keeps one live Register stream to the extender; health changes push a
    fresh inventory message down the same stream."""

    def __init__(self, backend: Backend, cfg: Config,
                 endpoint: Optional[str] = None) -> None:
        self.backend = backend
        self.cfg = cfg
        self.endpoint = endpoint or cfg.scheduler_endpoint
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
                yield inventory_to_request(self.cfg.node_name, inv, self.cfg)
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
