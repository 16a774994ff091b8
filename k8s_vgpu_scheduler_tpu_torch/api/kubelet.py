"""gRPC glue for the kubelet device-plugin API (v1beta1): the port's copy
of the JAX package's ``api/kubelet.py``.

Hand-rolled service registration (no grpc_tools); wire behavior matches
the generated stubs the reference links (pkg/device-plugin/plugin.go
:264–391 serves the same five methods).  Only the node agent's gRPC edge
imports it.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb

API_VERSION = "v1beta1"
DEVICEPLUGIN_SERVICE = "v1beta1.DevicePlugin"
REGISTRATION_SERVICE = "v1beta1.Registration"


def add_deviceplugin_service(server: grpc.Server, impl) -> None:
    """``impl`` provides GetDevicePluginOptions, ListAndWatch (generator),
    GetPreferredAllocation, Allocate, PreStartContainer."""
    handler = grpc.method_handlers_generic_handler(
        DEVICEPLUGIN_SERVICE,
        {
            "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                impl.GetDevicePluginOptions,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.DevicePluginOptions.SerializeToString,
            ),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                impl.ListAndWatch,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ListAndWatchResponse.SerializeToString,
            ),
            "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
                impl.GetPreferredAllocation,
                request_deserializer=pb.PreferredAllocationRequest.FromString,
                response_serializer=pb.PreferredAllocationResponse.SerializeToString,
            ),
            "Allocate": grpc.unary_unary_rpc_method_handler(
                impl.Allocate,
                request_deserializer=pb.AllocateRequest.FromString,
                response_serializer=pb.AllocateResponse.SerializeToString,
            ),
            "PreStartContainer": grpc.unary_unary_rpc_method_handler(
                impl.PreStartContainer,
                request_deserializer=pb.PreStartContainerRequest.FromString,
                response_serializer=pb.PreStartContainerResponse.SerializeToString,
            ),
        },
    )
    server.add_generic_rpc_handlers((handler,))


def add_registration_service(server: grpc.Server, register_fn) -> None:
    """Fake-kubelet side: ``register_fn(request, context) -> Empty``."""
    handler = grpc.method_handlers_generic_handler(
        REGISTRATION_SERVICE,
        {
            "Register": grpc.unary_unary_rpc_method_handler(
                register_fn,
                request_deserializer=pb.RegisterRequest.FromString,
                response_serializer=pb.Empty.SerializeToString,
            )
        },
    )
    server.add_generic_rpc_handlers((handler,))


class DevicePluginStub:
    """Client stub for driving a DevicePlugin server (tests / fake kubelet)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{DEVICEPLUGIN_SERVICE}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{DEVICEPLUGIN_SERVICE}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{DEVICEPLUGIN_SERVICE}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{DEVICEPLUGIN_SERVICE}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{DEVICEPLUGIN_SERVICE}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


def registration_stub(channel: grpc.Channel):
    return channel.unary_unary(
        f"/{REGISTRATION_SERVICE}/Register",
        request_serializer=pb.RegisterRequest.SerializeToString,
        response_deserializer=pb.Empty.FromString,
    )
