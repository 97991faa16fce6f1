"""The tree-attention calls' least time over their device time, in
percent, over the traced window: the least time of each call is the
work it asks for (roofline/work.py) at the card's peaks; the device
time is the tree kernel's split pass and the combine pass it launches
(``split_combine_kernel``, shared with paged attention, which a
tree-mode engine never launches)."""

KERNELS = ("tree_split_kernel", "split_combine_kernel")


def read(m):
    t = m["trace"]
    if not t or not m["tree_calls"]:
        return None
    dev = sum(s for n, s in t["kernel_s"].items()
              if any(k in n for k in KERNELS))
    return 100.0 * m["tree_bound_s"] / dev if dev > 0 else None
