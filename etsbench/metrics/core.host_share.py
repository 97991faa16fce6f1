"""Share of the window the host spent outside every layer span: the
serving loop's scheduling, the tree bookkeeping and Python between the
calls (harness spans around prefill, decode, PRM, embedder, selection)."""


def read(m):
    inside = sum(m["spans"][k][0] for k in
                 ("prefill", "decode", "prm", "embed", "select"))
    return 1.0 - inside / m["window_s"]
