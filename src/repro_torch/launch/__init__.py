"""Entry points (port of ``repro.launch``): ``train`` (local training
plus a checkpoint) and ``serve`` (train, then an online serving loop on
one or more engine replicas).  The production-mesh dry run is not
ported (``ROADMAP.md`` queue 1 item 6)."""
