#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script
exits non-zero):

  1. device  — the card's name and power limit (``nvidia-smi``), the
               torch and CUDA versions;
  2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/
               csrc`` with nvcc (all sources at once), with the ptxas
               register report;
  3. parity  — each kernel against its plain PyTorch version on the card
               at Llama-3.2-1B head shapes (H 32, K 8, hd 64, page 16):
               ragged lengths, -1 table padding, dump entries, a fully
               masked row, tree batches of 48 and 160 leaves (the
               latter in leaf chunks), prefill at hd 128, float32 and
               bfloat16;
  4. main    — after an untimed warm-up (one prefill, two decode
               steps per mode), ETS search (``run_search_many``) over 4
               seeded prompts at the full width of ``llama3.2-1b``
               (random weights from a seed), LM + PRM + embedder, once
               with paged and once with tree attention.  Launch counters are zeroed just before
               each mode and read just after; every kernel must have
               launched.  The two modes' per-step decode logits must
               agree, every page must be free at the end;
  5. profile — ``torch.profiler`` over 8 tree-mode decode steps of the
               same sweep (32 rows): device busy share and the kernels
               that take the step's device time;
  6. replay  — each kernel against its plain version on the largest
               inputs the main path gave it, timed (CUDA events, L2
               flushed between launches; ``ms`` with the host's enqueue
               time, ``device_ms`` without, see ``Timer``) beside its
               bound and, for prefill, one ``scaled_dot_product_attention``
               call as a yardstick (the port never calls it), also at
               three shapes off the main path; the tree kernel also at
               each ``pages_per_split`` of a sweep;

then the kernels line ``{"kernels": [...]}`` and, last, the device line.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FLOP/s per input type (float32 on the CUDA cores, bf16 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}

# tolerances of the reference's own kernel tests (tests/test_kernels.py)
TOL = {("paged_attention", "float32"): 2e-5,
       ("tree_attention", "float32"): 3e-5,
       ("flash_prefill", "float32"): 2e-5}
TOL_BF16 = 2e-2
# paged vs tree decode logits at full width: both float32, summed in
# another order over 16 layers; logits are O(1)
TOL_MODES = 2e-3

LLAMA_VOCAB_NEWLINE = 198       # "\n" in the Llama 3 tokenizer
LLAMA_VOCAB_EOS = 128001        # <|end_of_text|>


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Per-launch CUDA-event timing with the L2 flushed between launches
    (the decode and prefill callers meet their operands cold).

    ``ms`` starts its event right after the flush, so it also counts
    the time the card waits while the host issues the call (the
    wrapper's checks, allocations and launches) whenever that outlasts
    the flush.  ``device_ms`` is device time: after the flush the card
    spins for about a millisecond (``torch.cuda._sleep``) while the host
    enqueues the call, so the start event fires only when the call's
    first kernel is already queued."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3,
           spin: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def device_ms(self, fn) -> float:
        return self.ms(fn, spin=True)


# ---------------------------------------------------------------------------
# inputs at Llama-3.2-1B head shapes
# ---------------------------------------------------------------------------

def paged_inputs(torch, np, rng, dtype, B=32, H=32, K=8, hd=64, S=16, P=512,
                 T=22):
    kp = torch.as_tensor(rng.normal(size=(P, S, K, hd)), dtype=dtype,
                         device="cuda")
    vp = torch.as_tensor(rng.normal(size=(P, S, K, hd)), dtype=dtype,
                         device="cuda")
    q = torch.as_tensor(rng.normal(size=(B, H, hd)), dtype=dtype,
                        device="cuda")
    bt = np.full((B, T), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B - 1):          # the last row stays fully masked
        n = int(rng.integers(1, T + 1))
        bt[b, :n] = rng.choice(P - 1, n, replace=False)
        lens[b] = int(rng.integers(1, n * S + 1))
    return (q, kp, vp, torch.as_tensor(bt, device="cuda"),
            torch.as_tensor(lens, device="cuda"))


def tree_inputs(torch, np, rng, dtype, B=32, H=32, K=8, hd=64, S=16, P=512,
                problems=4):
    from repro_torch.kvcache import build_tree_metadata
    kp = torch.as_tensor(rng.normal(size=(P, S, K, hd)), dtype=dtype,
                         device="cuda")
    vp = torch.as_tensor(rng.normal(size=(P, S, K, hd)), dtype=dtype,
                         device="cuda")
    q = torch.as_tensor(rng.normal(size=(B, H, hd)), dtype=dtype,
                        device="cuda")
    # `problems` x 7 leaves share a 10-page prefix per problem; each leaf
    # owns a ragged tail; the rows past them are inactive (fully masked)
    free = list(rng.permutation(P - 1))
    tables, lengths = [], []
    for _ in range(problems):
        prefix = [int(free.pop()) for _ in range(10)]
        for _ in range(7):
            tail_tok = int(rng.integers(1, 3 * S))
            n_tail = -(-tail_tok // S)
            tables.append(prefix + [int(free.pop()) for _ in range(n_tail)])
            lengths.append(10 * S + tail_tok)
    tables += [[] for _ in range(B - len(tables))]
    lengths += [0] * (B - len(lengths))
    meta = build_tree_metadata(tables, lengths, S, pad_page=P - 1,
                               check=True)
    if meta.page_list.shape[0] == meta.n_unique:
        fail("tree inputs carry no dump entries")
    return (q, kp, vp, torch.as_tensor(meta.page_list, device="cuda"),
            torch.as_tensor(meta.page_mask, device="cuda"),
            torch.as_tensor(meta.page_lens, device="cuda"))


def flash_inputs(torch, rng, dtype, B=4, S=256, H=32, K=8, hd=64):
    mk = lambda n: torch.as_tensor(rng.normal(size=(B, S, n, hd)),  # noqa
                                   dtype=dtype, device="cuda")
    return mk(H), mk(K), mk(K)


# ---------------------------------------------------------------------------
# work of one call: bytes each input/output moves once, and FLOPs
# ---------------------------------------------------------------------------

def paged_work(args, scale):
    q, kp, _, bt, lens = args
    B, H, hd = q.shape
    _, S, K, _ = kp.shape
    el = q.element_size()
    bt_h, lens_h = bt.cpu().numpy(), lens.cpu().numpy()
    uniq = {}        # page -> valid slots the function must read once
    row_tok = 0      # (row, slot) pairs attended
    for b in range(B):
        n = int(lens_h[b])
        for t in range(min(-(-n // S), bt_h.shape[1])):
            pg = int(bt_h[b, t])
            if pg >= 0:
                valid = min(S, n - t * S)
                row_tok += valid
                uniq[pg] = max(uniq.get(pg, 0), valid)
    kv = sum(uniq.values()) * K * hd * 2 * el
    nbytes = kv + 2 * q.numel() * el + bt.numel() * 4 + lens.numel() * 4
    flops = 4 * row_tok * H * hd
    return nbytes, flops


def tree_work(args, scale):
    q, kp, _, pl, pm, plen = args
    B, H, hd = q.shape
    _, S, K, _ = kp.shape
    el = q.element_size()
    lens_h = plen.cpu().numpy().astype(np.int64)
    mask_h = pm.cpu().numpy().astype(np.int64)
    kv = int(lens_h.sum()) * K * hd * 2 * el
    nbytes = kv + 2 * q.numel() * el + pl.numel() * 4 + pm.numel() \
        + plen.numel() * 4
    flops = 4 * H * hd * int((mask_h.sum(axis=1) * lens_h).sum())
    return nbytes, flops


def flash_work(args, scale):
    q, k, _ = args
    B, S, H, hd = q.shape
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    return nbytes, flops


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(ptxas_info=True)
    secs = time.perf_counter() - t0
    # per kernel instance (mangled entry name): registers, then spills
    regs = {name: [ln.split("ptxas info    : ")[-1].strip()
                   for ln in log.splitlines()
                   if "Compiling entry" in ln or "registers" in ln
                   or "spill" in ln]
            for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": regs})


def check(name, dtype, out, ref, case):
    import torch
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[(name, "float32")] if dtype == torch.float32 else TOL_BF16
    finite = bool(torch.isfinite(out.float()).all())
    emit({"phase": "parity", "kernel": name, "case": case,
          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
          "tol": tol, "finite": finite})
    if not finite or not err <= tol:
        fail(f"{name} ({case}, {dtype}) disagrees with its plain version: "
             f"max_abs_err {err} > {tol}")
    return err


def phase_parity(torch, np):
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    scale = 64 ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        a = paged_inputs(torch, np, rng, dt)
        out = ops.paged_attention(*a, scale=scale)
        check("paged_attention", dt, out,
              ref.paged_attention_ref(*a, scale=scale),
              "ragged, -1 padded, one zero-length row")
        if bool(out[-1].ne(0).any()):
            fail("paged_attention: zero-length row is not zero")
        # 28, 42 and 133 live leaves; at B = 160 the leaves' state does
        # not fit one CTA's shared memory, so the split pass cuts the
        # batch into leaf chunks and the last chunk ends in masked rows
        for B, problems, P in ((32, 4, 512), (48, 6, 512), (160, 19, 1024)):
            a = tree_inputs(torch, np, rng, dt, B=B, problems=problems, P=P)
            out = ops.tree_attention(*a, scale=scale)
            check("tree_attention", dt, out,
                  ref.tree_attention_ref(*a, scale=scale),
                  f"B={B}, shared prefixes, dump entries, "
                  f"{B - 7 * problems} fully masked rows")
            if bool(out[7 * problems:].ne(0).any()):
                fail("tree_attention: fully masked rows are not zero")
        for S, hd in ((8, 64), (256, 64), (256, 128)):
            # a bucket below the 32-key tile, the main path's bucket, and
            # the widest head dim the kernel takes
            a = flash_inputs(torch, rng, dt, S=S, hd=hd)
            check("flash_prefill", dt, ops.flash_prefill(*a, scale=scale),
                  ref.flash_prefill_ref(*a, scale=scale),
                  f"causal, S={S}, hd={hd}")
        a = flash_inputs(torch, rng, dt, S=128)
        check("flash_prefill", dt,
              ops.flash_prefill(*a, scale=scale, window=48),
              ref.flash_prefill_ref(*a, scale=scale, window=48),
              "causal, window 48, S=128")


class Recorder:
    """Keeps a copy of the largest call each kernel wrapper received on
    the main path, for the replay phase.  Decode calls are sized only at
    KV layer 0 (one host sync per decode step, not one per layer)."""

    def __init__(self, ops):
        self.ops = ops
        self.best = {}
        self.layer0_ptr = None      # the running engine's pool.k base
        self.orig = {n: getattr(ops, n) for n in
                     ("paged_attention", "tree_attention", "flash_prefill")}

    def _wrap(self, name, size_fn, decode):
        orig = self.orig[name]

        def wrapper(*args, **kw):
            if not decode or args[1].data_ptr() == self.layer0_ptr:
                size = size_fn(args)
                if size > self.best.get(name, (-1,))[0]:
                    self.best[name] = (size, [a.clone() for a in args],
                                       dict(kw))
            return orig(*args, **kw)
        return wrapper

    def __enter__(self):
        self.ops.paged_attention = self._wrap(
            "paged_attention", lambda a: int(a[4].sum()), True)
        self.ops.tree_attention = self._wrap(
            "tree_attention",
            lambda a: int((a[4].sum(1) * a[5]).sum()), True)
        self.ops.flash_prefill = self._wrap(
            "flash_prefill", lambda a: a[0].shape[0] * a[0].shape[1], False)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.ops, n, f)


def run_mode(torch, np, mode, models, prompts, recorder):
    from repro_torch.core import ETSConfig, SearchConfig, run_search_many
    from repro_torch.kernels import ops
    from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                     PagedEngine)
    (lm, lp), (prm, pp), (emb, ep) = models
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=1024, page_size=16, max_batch=32, max_seq_len=512,
        attention=mode, trace_logits=True))
    backend = LMBackend(engine, prm, pp, emb, ep, BackendConfig(
        step_token=LLAMA_VOCAB_NEWLINE, eos_token=LLAMA_VOCAB_EOS,
        max_step_tokens=32, max_depth=8, temperature=0.0),
        answer_fn=lambda toks: None)
    scfg = SearchConfig(method="ets", width=8, max_steps=3,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                      cluster_threshold=0.2))
    times = {"prefill": 0.0, "decode": 0.0}

    def timed(key, fn):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return out
        return inner

    engine.prefill_many = timed("prefill", engine.prefill_many)
    engine.decode = timed("decode", engine.decode)
    recorder.layer0_ptr = engine.pool.k.data_ptr()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorder:
        results = run_search_many(backend, scfg, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    engine.alloc.check_invariants()
    if engine.alloc.used_pages != 0 or engine.alloc.seqs:
        fail(f"{mode}: {engine.alloc.used_pages} pages still held after "
             f"the problems retired")
    for r in results:
        if len(r.tree.nodes) < 2:
            fail(f"{mode}: a search produced no children")
    info = {
        "phase": "main", "mode": mode, "wall_s": wall,
        "launches": launches,
        "prefill_tokens": engine.n_prefill_tokens,
        "prefill_tok_s": engine.n_prefill_tokens / max(times["prefill"],
                                                       1e-9),
        "decoded_tokens": engine.n_decoded_tokens,
        "decode_steps": engine.n_decode_steps,
        "decode_tok_s": engine.n_decoded_tokens / max(times["decode"], 1e-9),
        "unique_pages_streamed": engine.unique_pages_streamed,
        "logical_pages_streamed": engine.logical_pages_streamed,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "nodes": [len(r.tree.nodes) for r in results],
    }
    emit(info)
    return results, engine.logits_trace, launches, info


def compare_modes(np, res_p, trace_p, res_t, trace_t):
    toks = lambda rs: [t for r in rs for n in r.tree.nodes  # noqa: E731
                       for t in ((n.payload or {}).get("tokens") or [])]
    a, b = toks(res_p), toks(res_t)
    agree = sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)
    worst, n_cmp = 0.0, 0
    for lp, lt in zip(trace_p, trace_t):
        if lp.shape != lt.shape:
            break
        if not (np.isfinite(lp).all() and np.isfinite(lt).all()):
            fail("non-finite decode logits")
        worst = max(worst, float(np.abs(lp - lt).max()))
        n_cmp += 1
        if not np.array_equal(lp.argmax(-1), lt.argmax(-1)):
            break                   # streams diverge after this step
    emit({"phase": "modes", "token_agreement": agree,
          "logit_steps_compared": n_cmp, "max_abs_logit_diff": worst,
          "tol": TOL_MODES})
    if n_cmp == 0 or worst > TOL_MODES:
        fail(f"paged and tree decode disagree: {worst} over {n_cmp} steps")


def phase_replay(torch, recorder, launches, timer):
    from repro_torch.kernels import ops, ref
    plain = {"paged_attention": ref.paged_attention_ref,
             "tree_attention": ref.tree_attention_ref,
             "flash_prefill": ref.flash_prefill_ref}
    work = {"paged_attention": paged_work, "tree_attention": tree_work,
            "flash_prefill": flash_work}
    lines = []
    for k in ops.KERNELS:
        if k.name not in recorder.best:
            fail(f"{k.name} never ran on the main path")
        _, args, kw = recorder.best[k.name]
        fn = recorder.orig[k.name]
        out = fn(*args, **kw)
        want = plain[k.name](*args, scale=kw["scale"])
        err = check(k.name, args[0].dtype, out, want, "main-path inputs")
        kernel_ms = timer.ms(lambda: fn(*args, **kw))
        device_ms = timer.device_ms(lambda: fn(*args, **kw))
        plain_ms = timer.ms(lambda: plain[k.name](*args, scale=kw["scale"]))
        library_ms = None
        extra = {}
        if k.name == "tree_attention":
            # pages per split trades CTAs (parallelism) and partials for
            # the combine against the length of each CTA's page stream
            extra["pages_per_split_default"] = ops.TREE_PAGES_PER_SPLIT
            extra["device_ms_by_pages_per_split"] = {
                pps: timer.device_ms(lambda: fn(*args, **dict(
                    kw, pages_per_split=pps)))
                for pps in (1, 2, 4, 8, 16, 32)}
        if k.name == "flash_prefill":
            sdpa = sdpa_call(torch, *args, scale=kw["scale"])
            library_ms = timer.ms(sdpa)
            extra["library_device_ms"] = timer.device_ms(sdpa)
            extra["off_path"] = flash_off_path(torch, timer)
        nbytes, flops = work[k.name](args, kw["scale"])
        b_ms, b_by = bound_ms(nbytes, flops, args[0].dtype)
        shapes = [list(a.shape) for a in args]
        emit({"phase": "replay", "kernel": k.name, "shapes": shapes,
              "dtype": str(args[0].dtype), "bytes": nbytes, "flops": flops,
              "ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": b_ms, **extra})
        lines.append({"name": k.name, "route": "cuda", "source": k.source,
                      "replaces": k.replaces, "launches": launches[k.name],
                      "max_abs_err": err, "ms": kernel_ms,
                      "device_ms": device_ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms})
    return lines


def sdpa_call(torch, q, k, v, *, scale):
    """One ``scaled_dot_product_attention`` call over the same packed
    inputs (kv heads repeated to the query heads), as a yardstick."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale)


def flash_off_path(torch, timer):
    """Flash prefill against SDPA at shapes the main path does not give
    it: the widest head dim, a 1024-token bucket, and bf16."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(1)
    rows = []
    for B, S, hd, dt in ((2, 256, 128, torch.float32),
                         (4, 1024, 64, torch.float32),
                         (4, 256, 64, torch.bfloat16)):
        a = flash_inputs(torch, rng, dt, B=B, S=S, hd=hd)
        scale = hd ** -0.5
        err = check("flash_prefill", dt, ops.flash_prefill(*a, scale=scale),
                    ref.flash_prefill_ref(*a, scale=scale),
                    f"off-path timing, B={B}, S={S}, hd={hd}")
        sdpa = sdpa_call(torch, *a, scale=scale)
        rows.append({"shape": [B, S, 32, 8, hd],
                     "dtype": str(dt).replace("torch.", ""),
                     "max_abs_err": err,
                     "device_ms": timer.device_ms(
                         lambda: ops.flash_prefill(*a, scale=scale)),
                     "library_device_ms": timer.device_ms(sdpa)})
    return rows


def phase_profile(torch, models, prompts):
    """Where one decode step's time goes: profile 8 tree-mode steps of
    32 rows (4 prompts x 8 branches) after a warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=1024, page_size=16, max_batch=32, max_seq_len=512,
        attention="tree"))
    rows = [b for s in engine.prefill_many(prompts)
            for b in engine.branch(s, 8)]
    engine.decode(rows, 1, key=0, temperature=0.0)
    torch.cuda.synchronize()
    steps = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode(rows, steps, key=0, temperature=0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile", "mode": "tree", "rows": len(rows),
          "steps": steps, "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": busy_ms / steps,
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
          "device_events": sum(n for _, n in by_name.values()),
          # the tree kernel's two launches (split pass + combine pass)
          "tree_attention_ms_per_step": sum(
              ms for name, (ms, _) in by_name.items()
              if name.startswith("void tree_")) / steps,
          "top": [{"name": name[:90], "ms_per_step": ms / steps,
                   "launches_per_step": n / steps}
                  for name, (ms, n) in top]})


def warm_up(torch, models, prompts):
    """One prefill and two decode steps per attention mode, untimed, so
    the timed runs do not pay one-time costs (kernel library loads,
    cuBLAS handles, allocator growth)."""
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    for mode in ("paged", "tree"):
        engine = PagedEngine(lm, lp, EngineConfig(
            n_pages=1024, page_size=16, max_batch=32, max_seq_len=512,
            attention=mode))
        rows = [b for s in engine.prefill_many(prompts)
                for b in engine.branch(s, 2)]
        engine.decode(rows, 2, key=0, temperature=0.0)
    torch.cuda.synchronize()


def phase_main(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    cfg = get_config("llama3.2-1b")
    emb_cfg = dataclasses.replace(get_config("tiny-embedder"),
                                  vocab_size=cfg.vocab_size)
    models = []
    for i, (c, vh) in enumerate([(cfg, False), (cfg, True),
                                 (emb_cfg, False)]):
        m = build_model(c, with_value_head=vh)
        gen = torch.Generator(device="cuda").manual_seed(i)
        models.append((m, m.init(gen)))
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, 128000, int(n))))
               for n in rng.integers(128, 257, 4)]
    warm_up(torch, models, prompts)
    recorder = Recorder(ops)
    res_p, trace_p, l_p, _ = run_mode(torch, np, "paged", models, prompts,
                                      recorder)
    res_t, trace_t, l_t, _ = run_mode(torch, np, "tree", models, prompts,
                                      recorder)
    if not (l_p["paged_attention"] and l_p["flash_prefill"]
            and l_t["tree_attention"] and l_t["flash_prefill"]):
        fail(f"a kernel of the path did not launch: paged {l_p}, tree {l_t}")
    compare_modes(np, res_p, trace_p, res_t, trace_t)
    launches = {n: l_p[n] + l_t[n] for n in l_p}
    phase_profile(torch, models, prompts)
    return recorder, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    phase_device(torch)
    phase_build()
    phase_parity(torch, np)
    recorder, launches = phase_main(torch, np)
    lines = phase_replay(torch, recorder, launches, Timer(torch))
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
