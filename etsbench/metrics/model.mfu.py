"""Useful model FLOPs in the window over the window's seconds at the
card's bfloat16 dense peak, in percent: the LM's prefill and decode at
2 x active parameters per token (output head included, embedding
lookup not) plus attention over the real context, the PRM on its
unpadded tokens, the embedder."""


def read(m):
    peak = m["peaks"]["flops_per_s"]["bfloat16"]
    return 100.0 * m["useful_flops"] / (m["window_s"] * peak)
