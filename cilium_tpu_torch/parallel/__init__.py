"""Sharded serving on one card (the per-CPU / per-chip axis).

Reference: the JAX package's ``parallel/`` — the packet batch shards
over a device mesh; policy and ipcache are replicated, the conntrack
table is split into private per-shard slices, and packets are routed
to the shard that owns their flow by a symmetric flow hash (RSS-style),
so both directions of a flow land on one shard.  Here the mesh is S
shards on ONE device: the shard is a grid dimension of the serving
kernels, and the tables are the reference's global arrays.  The same
:class:`ShardMesh` drives the data-parallel train step
(``ml.make_train_step(mesh=...)``, ``ml.train(mesh=...)``), whose batch
blocks are a grid dimension of the trainer's kernels.
"""

from .mesh import (  # noqa: F401
    ShardMesh,
    add_host_drops,
    add_route_overflow,
    ct_rows_slot_ids,
    flow_shard_ids,
    make_mesh,
    make_sharded_ring,
    make_sharded_serve_step,
    make_sharded_step,
    route_by_flow,
    shard_state,
    sharded_serve,
    sharded_ct_update_plain,
    sharded_ring_append_plain,
    sharded_serve_launch,
    sharded_serve_plain,
    sharded_verdict_plain,
)
