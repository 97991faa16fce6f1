"""The flash-prefill calls' least time over their device time, in
percent, over the profiled stretch, the work counted on the rows'
unpadded causal lengths (roofline/work.py)."""


def read(m):
    t = m["trace"]
    if not t or not m["flash_calls"]:
        return None
    dev = sum(s for n, s in t["kernel_s"].items() if "flash_prefill" in n)
    return 100.0 * m["flash_bound_s"] / dev if dev > 0 else None
