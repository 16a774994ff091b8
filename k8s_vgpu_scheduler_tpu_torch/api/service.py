"""gRPC service glue for DeviceService, the node agent's register stream
to the scheduler: the port's copy of the JAX package's ``api/service.py``,
on the same method path.

Instead of generated ``*_pb2_grpc.py`` stubs the handler goes through
grpcio's generic-handler API — the same wire behavior as the reference's
generated service (pkg/api/device_register.pb.go).
"""

from __future__ import annotations

import grpc

from . import device_register_pb2 as pb

SERVICE_NAME = "vtpu.api.DeviceService"
REGISTER_METHOD = f"/{SERVICE_NAME}/Register"


def add_device_service(server: grpc.Server, register_handler) -> None:
    """``register_handler(request_iterator, context) -> RegisterReply``."""
    handler = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Register": grpc.stream_unary_rpc_method_handler(
                register_handler,
                request_deserializer=pb.RegisterRequest.FromString,
                response_serializer=pb.RegisterReply.SerializeToString,
            )
        },
    )
    server.add_generic_rpc_handlers((handler,))


def register_stub(channel: grpc.Channel):
    """Client-side multicallable for the Register stream."""
    return channel.stream_unary(
        REGISTER_METHOD,
        request_serializer=pb.RegisterRequest.SerializeToString,
        response_deserializer=pb.RegisterReply.FromString,
    )
