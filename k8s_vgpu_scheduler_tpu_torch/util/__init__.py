"""The port's copies of the JAX package's ``util/`` modules that the node
agent needs: the annotation vocabulary, its codec, the node lock, the
bind handshake, the shim-install policy, its configuration and its
tracer.  Stdlib only."""
