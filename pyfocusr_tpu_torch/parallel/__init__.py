"""Many-pair and sharded workloads over the registration pipeline.

Counterpart of ``pyfocusr_tpu/parallel/``: ``cohort`` (the cohort and the
statistical shape model), ``groupwise`` (symmetric and all-pairs
registration), ``bigmesh`` (one pair's fine refine, vertex-sharded) and
``distributed`` (the ``torch.distributed`` counterpart of JAX's meshes and
``shard_map``: device meshes, collectives, rank processes).
"""
