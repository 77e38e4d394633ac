"""Multi-device training over ``torch.distributed`` (counterpart of
``tpu_sage/dist/``).

One process per rank. The graph's node axis is range-partitioned: rank ``r``
owns rows ``[r·m, (r+1)·m)`` of every per-node array (``partition``), and the
rows of nodes other ranks own arrive by halo exchange (``halo``). The
partitioned trainer (``train``) samples, exchanges and steps on each rank's
shard and all-reduces one gradient buffer per step; ``data_parallel``
replicates the graph and splits the batch. ``mesh`` brings the process group
up and down, ``debug`` compares the replicas.

The JAX package runs these as ``shard_map`` programs over a device mesh in
one process; here each rank is a process bound to one card (NCCL) or to the
CPU (gloo). ``unsupervised`` trains the NCE objective on the same shards;
``mesh.Layout2D`` lays the ranks out as a 2-D grid for the hierarchical
``hier2d`` exchange (``(host, chip)``) and for tensor parallelism (``(data,
model)``).
"""
