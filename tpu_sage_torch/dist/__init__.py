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
CPU (gloo). Not ported yet (ROADMAP Queue 1 item 14): the partitioned
unsupervised loop, the hierarchical ``hier2d`` exchange over a 2-D
``(host, chip)`` layout, tensor-parallel ``model_axis``.
"""
