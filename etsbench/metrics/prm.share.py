"""Share of the window inside the PRM's scoring calls (synchronised)."""


def read(m):
    s, n = m["spans"]["prm"]
    return s / m["window_s"] if n else None
