"""Host milliseconds per problem-step in ETS's selection (the ILP and
the clustering), from the harness span around it."""


def read(m):
    s, n = m["spans"]["select"]
    return 1e3 * s / n if n else None
