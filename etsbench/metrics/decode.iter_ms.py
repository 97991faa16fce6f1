"""Wall milliseconds per decode iteration of the serving stream
(synchronised)."""


def read(m):
    s, n = m["spans"]["decode"]
    return 1e3 * s / n if n else None
