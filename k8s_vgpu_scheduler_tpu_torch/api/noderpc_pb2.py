"""The node monitor's RPC (``vtpu.noderpc.NodeTPUInfo``), the port's copy
of the JAX package's ``api/noderpc_pb2.py``: the same schema and field
numbers (``usage_only``, ``ReportUsage``, ``UsageCounters`` included) as a
serialized ``FileDescriptorProto``, in a descriptor pool of its own so
that both packages load in one process.  Only the monitor's RPC and the
register stream import it."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(
    b'\n.k8s_vgpu_scheduler_tpu_torch/api/noderpc.proto\x12\x0cvtpu.node'
    b'rpc"\x17\n\x08ProcSlot\x12\x0b\n\x03pid\x18\x01 \x01(\x05"\xb6\x01'
    b'\n\nRegionInfo\x12\r\n\x05uuids\x18\x01 \x03(\t\x12\r\n\x05limit'
    b'\x18\x02 \x03(\x04\x12\x10\n\x08sm_limit\x18\x03 \x03(\x04\x12\x0c'
    b'\n\x04used\x18\x04 \x03(\x04\x12\x10\n\x08priority\x18\x05 \x01('
    b'\x05\x12\x1a\n\x12utilization_switch\x18\x06 \x01(\x05\x12\x15\n\r'
    b'oversubscribe\x18\x07 \x01(\x05\x12%\n\x05procs\x18\x08 \x03(\x0b2'
    b'\x16.vtpu.noderpc.ProcSlot"\xb3\x02\n\rUsageCounters\x12\x0e\n\x06'
    b'ctrkey\x18\x01 \x01(\t\x12\r\n\x05chips\x18\x02 \x01(\x05\x12\x0e'
    b'\n\x06active\x18\x03 \x01(\x08\x12\x15\n\roversubscribe\x18\x04 '
    b'\x01(\x08\x12\x14\n\x0cchip_seconds\x18\x05 \x01(\x01\x12\x18\n'
    b'\x10hbm_byte_seconds\x18\x06 \x01(\x01\x12\x19\n\x11throttled_seco'
    b'nds\x18\x07 \x01(\x01\x12\x1d\n\x15oversub_spill_seconds\x18\x08 '
    b'\x01(\x01\x12\x10\n\x08window_s\x18\t \x01(\x01\x12\x11\n\tqos_cla'
    b'ss\x18\n \x01(\t\x12\x16\n\x0eqos_weight_pct\x18\x0b \x01(\x05\x12'
    b'\x1e\n\x16qos_wait_seconds_total\x18\x0c \x01(\x01\x12\x15\n\rqos_'
    b'wait_hist\x18\r \x03(\x04"L\n\x0bReportUsage\x12\x0e\n\x06nodeid'
    b'\x18\x01 \x01(\t\x12-\n\x08counters\x18\x02 \x03(\x0b2\x1b.vtpu.no'
    b'derpc.UsageCounters"B\n\x08PodUsage\x12\x0e\n\x06ctrkey\x18\x01 '
    b'\x01(\t\x12&\n\x04info\x18\x02 \x01(\x0b2\x18.vtpu.noderpc.RegionI'
    b'nfo"7\n\x11GetNodeTPURequest\x12\x0e\n\x06ctrkey\x18\x01 \x01(\t'
    b'\x12\x12\n\nusage_only\x18\x02 \x01(\x08"s\n\x0fGetNodeTPUReply'
    b'\x12\x0e\n\x06nodeid\x18\x01 \x01(\t\x12&\n\x06usages\x18\x02 \x03'
    b'(\x0b2\x16.vtpu.noderpc.PodUsage\x12(\n\x05usage\x18\x03 \x01(\x0b'
    b'2\x19.vtpu.noderpc.ReportUsage2[\n\x0bNodeTPUInfo\x12L\n\nGetNodeT'
    b'PU\x12\x1f.vtpu.noderpc.GetNodeTPURequest\x1a\x1d.vtpu.noderpc.Get'
    b'NodeTPUReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, __name__, globals())
