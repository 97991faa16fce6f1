"""Rows decoded per iteration: the engine's decoded-token count over
its iteration count, in the window."""


def read(m):
    c = m["counters"]
    return c["decoded"] / c["decode_steps"] if c["decode_steps"] else None
