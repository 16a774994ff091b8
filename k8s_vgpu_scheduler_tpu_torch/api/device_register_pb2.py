"""The node agent's register stream to the scheduler extender
(``vtpu.api.DeviceService``), the port's copy of the JAX package's
``api/device_register_pb2.py``: the same schema and field numbers as a
serialized ``FileDescriptorProto``, in a descriptor pool of its own so that
both packages load in one process.  Only the register stream imports it
(the card's machine has no protobuf)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(
    b'\n6k8s_vgpu_scheduler_tpu_torch/api/device_register.proto\x12\x08vtpu.'
    b'api"t\n\nChipDevice\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05count\x18'
    b'\x02 \x01(\x05\x12\x0e\n\x06devmem\x18\x03 \x01(\x05\x12\x0c\n\x04type'
    b'\x18\x04 \x01(\t\x12\x0e\n\x06health\x18\x05 \x01(\x08\x12\x0e\n\x06co'
    b'ords\x18\x06 \x03(\x05\x12\r\n\x05cores\x18\x07 \x01(\x05"@\n\x08Topol'
    b'ogy\x12\x12\n\ngeneration\x18\x01 \x01(\t\x12\x0c\n\x04mesh\x18\x02 '
    b'\x03(\x05\x12\x12\n\nwraparound\x18\x03 \x03(\x08"\xb3\x02\n\rUsageCou'
    b'nters\x12\x0e\n\x06ctrkey\x18\x01 \x01(\t\x12\r\n\x05chips\x18\x02 '
    b'\x01(\x05\x12\x0e\n\x06active\x18\x03 \x01(\x08\x12\x15\n\roversubscri'
    b'be\x18\x04 \x01(\x08\x12\x14\n\x0cchip_seconds\x18\x05 \x01(\x01\x12'
    b'\x18\n\x10hbm_byte_seconds\x18\x06 \x01(\x01\x12\x19\n\x11throttled_se'
    b'conds\x18\x07 \x01(\x01\x12\x1d\n\x15oversub_spill_seconds\x18\x08 '
    b'\x01(\x01\x12\x10\n\x08window_s\x18\t \x01(\x01\x12\x11\n\tqos_class'
    b'\x18\n \x01(\t\x12\x16\n\x0eqos_weight_pct\x18\x0b \x01(\x05\x12\x1e\n'
    b'\x16qos_wait_seconds_total\x18\x0c \x01(\x01\x12\x15\n\rqos_wait_hist'
    b'\x18\r \x03(\x04"\x94\x01\n\x0fRegisterRequest\x12\x0c\n\x04node\x18'
    b'\x01 \x01(\t\x12%\n\x07devices\x18\x02 \x03(\x0b2\x14.vtpu.api.ChipDev'
    b'ice\x12$\n\x08topology\x18\x03 \x01(\x0b2\x12.vtpu.api.Topology\x12&\n'
    b'\x05usage\x18\x04 \x03(\x0b2\x17.vtpu.api.UsageCounters" \n\rRegisterR'
    b'eply\x12\x0f\n\x07message\x18\x01 \x01(\t2Q\n\rDeviceService\x12@\n'
    b'\x08Register\x12\x19.vtpu.api.RegisterRequest\x1a\x17.vtpu.api.Registe'
    b'rReply(\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, __name__, globals())
