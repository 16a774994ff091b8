"""The node agent's wire schemas and their gRPC glue: kubelet's
device-plugin API and the register stream to the scheduler.  Every module
here imports grpc or protobuf; only the node agent's gRPC edge imports
them."""
