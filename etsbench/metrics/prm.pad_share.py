"""Padded token slots over all slots of the PRM's power-of-two buckets."""


def read(m):
    if not m["prm_slots"]:
        return None
    return 1.0 - m["prm_valid"] / m["prm_slots"]
