"""NodeTPUInfo gRPC server: per-container usage introspection (the port's
copy of the JAX package's ``monitor/noderpc.py``).

Reference: the monitor's NodeVGPUInfo service (cmd/vGPUmonitor/
pathmonitor.go:89–113, serving noderpc.proto).  The reference's
implementation is a stub (GetNodeVGPU returns an empty reply); here each
request snapshots the live shared regions the feedback loop has mapped.
The service keeps the JAX name and schema (``vtpu.noderpc.NodeTPUInfo``,
``api/noderpc_pb2.py``), so a client of either package talks to the
server of the other.  One of the two modules of the monitor that import
grpc and protobuf (with ``api/noderpc_pb2.py``); ``cmd/monitor.py`` loads
it only when ``--grpc-port`` is not 0.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import grpc

from ..api import noderpc_pb2 as pb

log = logging.getLogger(__name__)

SERVICE_NAME = "vtpu.noderpc.NodeTPUInfo"
GET_METHOD = f"/{SERVICE_NAME}/GetNodeTPU"


def snapshot_region(region) -> pb.RegionInfo:
    info = pb.RegionInfo(
        priority=region.priority,
        utilization_switch=region.utilization_switch,
        oversubscribe=region.oversubscribe,
    )
    for dev in range(region.num_devices):
        info.uuids.append(region.uuid(dev))
        info.limit.append(region.limit(dev))
        info.sm_limit.append(region.sm_limit(dev))
        # Actual occupancy alongside the cap: a reader must be able to
        # see per-device used memory without mmapping the region itself.
        info.used.append(region.used(dev))
    for pid in region.proc_pids():
        info.procs.append(pb.ProcSlot(pid=pid))
    return info


def usage_report(node_name: str, rows) -> pb.ReportUsage:
    """Sampler counter rows (accounting/sampler.py USAGE_FIELDS) → the
    ReportUsage message that rides on GetNodeTPUReply."""
    report = pb.ReportUsage(nodeid=node_name)
    for row in rows:
        report.counters.add(
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
    return report


class NodeTPUInfoServer:
    def __init__(self, loop, node_name: str, sampler=None) -> None:
        self.loop = loop  # FeedbackLoop
        self.node_name = node_name
        self.sampler = sampler  # Optional[accounting.UsageSampler]
        self._server: Optional[grpc.Server] = None

    # -- handler ---------------------------------------------------------------
    def get_node_tpu(self, request: pb.GetNodeTPURequest, context
                     ) -> pb.GetNodeTPUReply:
        reply = pb.GetNodeTPUReply(nodeid=self.node_name)
        if request.usage_only:
            # Counters only (the register-stream piggyback's fetch):
            # skip the per-region snapshots and the loop lock entirely —
            # the sampler keeps its own lock and its own copies.
            if self.sampler is not None:
                reply.usage.CopyFrom(
                    usage_report(self.node_name, self.sampler.snapshot()))
            return reply
        with self.loop.lock:
            for key, state in self.loop.containers.items():
                if request.ctrkey and key != request.ctrkey:
                    continue
                try:
                    usage = pb.PodUsage(
                        ctrkey=key, info=snapshot_region(state.region)
                    )
                except Exception:  # region unmapped mid-read — skip this one
                    log.exception("snapshot failed for %s", key)
                    continue
                reply.usages.append(usage)
        if self.sampler is not None:
            # Accounting piggyback: the same round-trip carries the
            # monotonic usage counters (no extra connection or endpoint).
            reply.usage.CopyFrom(
                usage_report(self.node_name, self.sampler.snapshot()))
        return reply

    # -- serving ---------------------------------------------------------------
    def serve(self, port: int, bind_addr: str = "[::]") -> int:
        """``bind_addr`` matters on hostNetwork DaemonSets: the default
        listens on every node interface (the endpoint is unauthenticated —
        restrict with a NetworkPolicy or bind 127.0.0.1 for node-local-only
        tooling)."""
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                "GetNodeTPU": grpc.unary_unary_rpc_method_handler(
                    self.get_node_tpu,
                    request_deserializer=pb.GetNodeTPURequest.FromString,
                    response_serializer=pb.GetNodeTPUReply.SerializeToString,
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        bound = self._server.add_insecure_port(f"{bind_addr}:{port}")
        if bound == 0:
            # grpc reports a failed bind as port 0 with no exception; a
            # silently dead RPC would strand every consumer of the
            # advertised service.
            raise OSError(f"NodeTPUInfo cannot bind {bind_addr}:{port}")
        self._server.start()
        log.info("NodeTPUInfo serving on %s:%d", bind_addr, bound)
        return bound

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1)
            self._server = None


def node_tpu_stub(channel: grpc.Channel):
    return channel.unary_unary(
        GET_METHOD,
        request_serializer=pb.GetNodeTPURequest.SerializeToString,
        response_deserializer=pb.GetNodeTPUReply.FromString,
    )
