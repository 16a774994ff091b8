"""Kubelet's device-plugin API v1beta1 (the messages of
``k8s.io/kubelet/pkg/apis/deviceplugin/v1beta1/api.proto``), the port's
copy of the JAX package's ``api/deviceplugin_pb2.py``: the same schema as
a serialized ``FileDescriptorProto``, in a descriptor pool of its own so
that both packages load in one process.  Only the gRPC edge of the node
agent imports it (the card's machine has no protobuf)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(
    b'\n3k8s_vgpu_scheduler_tpu_torch/api/deviceplugin.proto\x12\x07v1beta1"'
    b'\x07\n\x05Empty"z\n\x0fRegisterRequest\x12\x0f\n\x07version\x18\x01 '
    b'\x01(\t\x12\x10\n\x08endpoint\x18\x02 \x01(\t\x12\x15\n\rresource_name'
    b'\x18\x03 \x01(\t\x12-\n\x07options\x18\x04 \x01(\x0b2\x1c.v1beta1.Devi'
    b'cePluginOptions"]\n\x13DevicePluginOptions\x12\x1a\n\x12pre_start_requ'
    b'ired\x18\x01 \x01(\x08\x12*\n"get_preferred_allocation_available\x18'
    b'\x02 \x01(\x08"8\n\x14ListAndWatchResponse\x12 \n\x07devices\x18\x01 '
    b'\x03(\x0b2\x0f.v1beta1.Device"0\n\x0cTopologyInfo\x12 \n\x05nodes\x18'
    b'\x01 \x03(\x0b2\x11.v1beta1.NUMANode"\x16\n\x08NUMANode\x12\n\n\x02ID'
    b'\x18\x01 \x01(\x03"M\n\x06Device\x12\n\n\x02ID\x18\x01 \x01(\t\x12\x0e'
    b'\n\x06health\x18\x02 \x01(\t\x12\'\n\x08topology\x18\x03 \x01(\x0b2'
    b'\x15.v1beta1.TopologyInfo"P\n\x0fAllocateRequest\x12=\n\x12container_r'
    b'equests\x18\x01 \x03(\x0b2!.v1beta1.ContainerAllocateRequest".\n\x18Co'
    b'ntainerAllocateRequest\x12\x12\n\ndevicesIDs\x18\x01 \x03(\t"S\n\x10Al'
    b'locateResponse\x12?\n\x13container_responses\x18\x01 \x03(\x0b2".v1bet'
    b'a1.ContainerAllocateResponse"\xc8\x02\n\x19ContainerAllocateResponse'
    b'\x12:\n\x04envs\x18\x01 \x03(\x0b2,.v1beta1.ContainerAllocateResponse.'
    b'EnvsEntry\x12\x1e\n\x06mounts\x18\x02 \x03(\x0b2\x0e.v1beta1.Mount\x12'
    b'$\n\x07devices\x18\x03 \x03(\x0b2\x13.v1beta1.DeviceSpec\x12H\n\x0bann'
    b'otations\x18\x04 \x03(\x0b23.v1beta1.ContainerAllocateResponse.Annotat'
    b'ionsEntry\x1a+\n\tEnvsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n'
    b'\x05value\x18\x02 \x01(\t:\x028\x01\x1a2\n\x10AnnotationsEntry\x12\x0b'
    b'\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"E'
    b'\n\x05Mount\x12\x16\n\x0econtainer_path\x18\x01 \x01(\t\x12\x11\n\thos'
    b't_path\x18\x02 \x01(\t\x12\x11\n\tread_only\x18\x03 \x01(\x08"L\n\nDev'
    b'iceSpec\x12\x16\n\x0econtainer_path\x18\x01 \x01(\t\x12\x11\n\thost_pa'
    b'th\x18\x02 \x01(\t\x12\x13\n\x0bpermissions\x18\x03 \x01(\t".\n\x18Pre'
    b'StartContainerRequest\x12\x12\n\ndevicesIDs\x18\x01 \x03(\t"\x1b\n\x19'
    b'PreStartContainerResponse"f\n\x1aPreferredAllocationRequest\x12H\n\x12'
    b'container_requests\x18\x01 \x03(\x0b2,.v1beta1.ContainerPreferredAlloc'
    b'ationRequest"{\n#ContainerPreferredAllocationRequest\x12\x1b\n\x13avai'
    b'lable_deviceIDs\x18\x01 \x03(\t\x12\x1e\n\x16must_include_deviceIDs'
    b'\x18\x02 \x03(\t\x12\x17\n\x0fallocation_size\x18\x03 \x01(\x05"i\n'
    b'\x1bPreferredAllocationResponse\x12J\n\x13container_responses\x18\x01 '
    b'\x03(\x0b2-.v1beta1.ContainerPreferredAllocationResponse"9\n$Container'
    b'PreferredAllocationResponse\x12\x11\n\tdeviceIDs\x18\x01 \x03(\t2F\n'
    b'\x0cRegistration\x126\n\x08Register\x12\x18.v1beta1.RegisterRequest'
    b'\x1a\x0e.v1beta1.Empty"\x002\xa3\x03\n\x0cDevicePlugin\x12H\n\x16GetDe'
    b'vicePluginOptions\x12\x0e.v1beta1.Empty\x1a\x1c.v1beta1.DevicePluginOp'
    b'tions"\x00\x12A\n\x0cListAndWatch\x12\x0e.v1beta1.Empty\x1a\x1d.v1beta'
    b'1.ListAndWatchResponse"\x000\x01\x12e\n\x16GetPreferredAllocation\x12#'
    b'.v1beta1.PreferredAllocationRequest\x1a$.v1beta1.PreferredAllocationRe'
    b'sponse"\x00\x12A\n\x08Allocate\x12\x18.v1beta1.AllocateRequest\x1a\x19'
    b'.v1beta1.AllocateResponse"\x00\x12\\\n\x11PreStartContainer\x12!.v1bet'
    b'a1.PreStartContainerRequest\x1a".v1beta1.PreStartContainerResponse"'
    b'\x00b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, __name__, globals())
