"""Entry points (port of ``repro.launch``): ``train`` (local training
plus a checkpoint), ``serve`` (train, then an online serving loop on
one or more engine replicas) and ``steps`` (input specs and the train,
prefill and decode steps of every architecture and input shape).  The
production-mesh dry run is the port's final slice (``ROADMAP.md`` queue
1 item 6)."""
