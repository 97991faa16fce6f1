"""Pages a per-sequence read would stream over the unique pages the
tree kernel streams, over the window's decode iterations."""


def read(m):
    c = m["counters"]
    return c["logical_pages"] / c["unique_pages"] if c["unique_pages"] \
        else None
