"""Entry points (port of ``repro.launch``): ``train`` (local training
plus a checkpoint) and ``serve`` (train, then an online serving loop).
The production-mesh dry run and multi-replica serving are later slices
(``ROADMAP.md`` queue 1 items 4 and 6)."""
