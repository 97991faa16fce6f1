"""Entry points (port of ``repro.launch``): ``train`` (local training
plus a checkpoint), ``serve`` (train, then an online serving loop on
one or more engine replicas) and ``steps`` (input specs and the train,
prefill and decode steps of every architecture and input shape),
``mesh`` and ``sharding`` (device meshes and the reference's sharding
policy over DTensor placements) and ``dryrun`` (every step on the
production mesh of a fake process group, counted per device)."""
