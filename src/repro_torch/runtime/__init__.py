"""Distributed runtime of the port: the worker-sharded execution of the
flat [W, P] matrix (``shardexec``), its row layout (``sharding``) and
the cross-shard edge gossip (``collectives``)."""
