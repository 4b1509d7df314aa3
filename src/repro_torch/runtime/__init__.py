"""Distributed runtime of the port: launch/train's round step and the
serving steps (``steps``), the matching gossip collectives and the
cross-shard edge gossip (``collectives``), worker layouts
(``sharding``) and the worker-sharded execution of the flat [W, P]
matrix (``shardexec``)."""
