"""Active-active extender replicas: the lease-sharded control plane (the
port's copy of the JAX package's ``shard/``).

N scheduler replicas run at once against one apiserver.  Node ownership
is partitioned by an epoch-numbered **shard map**: replica leases (the
deadline failure detector that watches node agents, ``health/lease.py``)
decide the live replica set, which is published on a coordination Node
that every replica converges on (``shardmap.py``).  A decision commit is
an apiserver **compare-and-swap** on the pod's decision annotations,
fenced by the shard epoch (``commit.py``): a replica holding a stale map
fails closed and the pod requeues.  When a replica dies, the survivors
bump the epoch and **adopt** its nodes: a grace, a replay of the decision
annotations as the write-ahead log, then a fresh node lease
(``rebalance.py``).

With no ``shard_replica`` configured the layer is inert and the
scheduler takes the single-replica path as it does without it.  The
package imports only the port's ``health/lease.py``, ``k8s/client.py``,
``util/types.py``, ``util/perf.py`` and ``util/trace.py``: no torch and
no numpy (the solve workers re-import the scheduler's chain).
"""

from .commit import (  # noqa: F401
    SHARD_EPOCH_ANNOTATION,
    SHARD_OWNER_ANNOTATION,
    cas_commit,
    cas_commit_many,
)
from .shardmap import (  # noqa: F401
    COORD_OBJECT,
    REPLICA_BEAT_PREFIX,
    SHARD_MAP_ANNOTATION,
    ShardConfig,
    ShardManager,
    ShardMap,
)
