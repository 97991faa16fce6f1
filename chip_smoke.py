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
               masked row, block tables of 160 pages that span many
               splits (-1 holes, a -1-only split, rows ending mid-page,
               zero-length and one-page rows) at several
               ``PAGED_PAGES_PER_SPLIT``, tree batches of 48 and 160
               leaves (the latter in leaf chunks), prefill at hd 128,
               float32 and bfloat16; all three at zamba2-7b's head shape
               (hd 112, G 1) and at qwen2-vl-7b's (hd 128, G 7), flash
               also with a 64-token window and on 1024-token float32
               buckets against float64; prefill
               buckets of 1024 and 2048 tokens (float32, hd 64 and 128)
               also against float64,
               once more with q and k scaled 3x (held to float64 only:
               the plain version is itself near the tolerance);
  4. main    — after an untimed warm-up (one prefill, two decode
               steps per mode), ETS search (``run_search_many``) over 4
               seeded prompts at the full width of ``llama3.2-1b``
               (random weights from a seed), LM + PRM + embedder, once
               with paged and once with tree attention.  Launch
               counters are zeroed just before each mode and read just
               after; every kernel must have
               launched.  The two modes' per-step decode logits must
               agree, every page must be free at the end;
  5. sampling — the threefry known answers on the card (key, split,
               fold_in, bits, two categorical draws over 128256 zeros,
               exact), the time of one 32-row draw against a greedy
               argmax, the sampler's kernel at the benchmark cells'
               draws (256 rows of bf16 logits at vocab 152064 and
               102400: tokens bit for bit against the plain version,
               device ms beside the plain version's and the bound of its
               bytes, int32 and float64 operations), then a sampled ETS
               search (temperature 1.0, width
               8, 2 steps) in paged and in tree mode: token agreement
               between the modes and sampled decode tok/s; where the
               modes draw different tokens, the gap between the two
               candidates' perturbed logits must stay within 1e-4; the
               tree-mode search again with the plain sampler in the
               kernel's place, every draw on equal logits giving equal
               tokens; the largest draw of the kernel's searches is its
               main-path call for the replay phase;
  6. profile — ``torch.profiler`` over 8 tree-mode decode steps of the
               same sweep (32 rows): device busy share and the kernels
               that take the step's device time;
  6a. mesh   — the main sweep again on engines placed on a 1-device
               ``DeviceMesh`` (a world-size-1 NCCL group, pool pages on
               ``model``): trees equal to the main phase's in both modes,
               every kernel launched, the shard fallbacks, the kernel
               seam refusing a 2-device mesh, then ``launch.serve --mesh
               1`` to its end;
  6b. dense_prefill — ``EngineConfig(prefill="dense")`` (the reference's
               oracle) against the flash kernel: the four prompts'
               prefill logits within 2e-5, both prefill ms, and the main
               sweep with the dense prefill giving the main phase's
               trees in both modes;
  7. streamed — one 2048-token prompt prefilled one-shot (flash kernel)
               and in 512-token streamed segments: K/V gap per layer
               (within 1e-3), last-token logit gap, equal 8-token greedy
               continuations (paged kernel), prefill tok/s and peak
               memory of each;
  8. swap    — one problem in paged mode (256-token prompt, 8 branches,
               32 tokens each) swapped out to pinned host memory, its
               freed pages overwritten, swapped back in, twice (fresh,
               then cached pinned buffers): bitwise equal pages, the
               next 8 greedy tokens of a twin that never swapped; MiB
               moved, swap-out / copy / swap-in ms and GB/s beside the
               host link's nominal 64 GB/s;
  9. serving — stage costs measured on the card, then 8 Poisson requests
               (7 prompts of 128-256 tokens and the 2048-token one,
               priorities, deadlines) through ``ServingLoop`` in tree
               mode on a pool too small for them, refill then lock-step:
               SLO report, decode tok/s, swap and IO counters, token
               agreement between the runs; every request must finish,
               demotion must fire and every page come back, and the
               tree kernel's largest call of the run is held against its
               plain version;
 10. train   — ``repro_torch.launch.train``'s model at ``llama3.2-1b``
               width (float32, vocab 32) trained 6 steps (batch 32 x 64
               tokens), then the same config with a value head through
               ``train_prm``: step ms (CUDA events; step 0 apart), tok/s,
               ``mfu`` against the fp32 peak, peak memory over the base,
               losses and grad norms (finite); a bitwise checkpoint
               round trip; one step at depth 2 on the card against the
               same step on the CPU (loss rtol 1e-5, grad norm 1e-4).
               Training runs no kernel of the port;
 11. example — ``examples/torch_train_and_search.py`` at its defaults
               (tiny LM + PRM trained 400 steps, REBASE and ETS over 10
               problems, paged mode, page size 8): ETS must solve 2 of
               10 and the LM's loss fall below 0.75 x its first;
 12. serve   — ``repro_torch.launch.serve`` (8 Poisson requests, 100
               train steps, tree mode, page size 8): every request
               finishes, the pool drains;
 13. families — zamba2-7b at full width and depth (81 layers, hd 112,
               G 1; PRM the same config at 6 layers), then
               deepseek-moe-16b (4 of 28 layers), mamba2-370m and
               rwkv6-7b (4 of 32) at full width, each freed before the
               next: a greedy ETS sweep (4 prompts, width 8, 3 steps) in
               paged and, where the model has attention, tree mode; the
               trees must be equal (rewards within 1e-5) and every
               kernel of the path launch (none for the SSMs); tok/s,
               pages, the state pool's MiB and peak pages, peak memory
               over the phase's base; for zamba2 a swap round whose KV
               and state pages come back bitwise; each path's largest
               kernel calls held against their plain versions;
 14. vlm     — qwen2-vl-7b at full width and depth (28 layers, hd 128,
               28 query heads over 4 kv heads: G 7; PRM a text model of
               the same width at 6 layers): the families phase's greedy
               sweep in paged and tree mode, equal trees, every kernel
               launched, the tree kernel's leaf chunks and the K/V bytes
               its split pass streams, each kernel's largest call timed;
 15. vlm_frontend — ``LM.forward`` of qwen2-vl-7b at full width, 2
               layers, float32: 64 patch embeds (frontend_dim 1280, an
               8 x 8 grid with distinct t/h/w streams) before 64 text
               tokens, the card's logits against the CPU's (1e-4);
 16. hubert  — hubert-xlarge at full width and depth (48 layers, frames
               of dim 512): ``hidden`` and ``forward`` on 4 x 500
               frames, the engine refusing the encoder, 2 layers in
               float32 against the CPU (1e-4); no kernel runs;
 17. replicas — (after serving) 2 engine replicas of the main path's
               models on the card: ``run_search_many`` over 8 prompts
               gives the one-replica trees, greedy and sampled;
               ``ReplicaServingLoop`` serves the serving phase's trace
               with every page back; (after serve)
               ``launch.serve --replicas 2`` runs to its end;
 18. train_families — (after hubert) three float32 train steps of each
               family through ``launch.steps.build_train_step`` (remat
               on) at full width, 8 x 64 tokens of its real vocabulary:
               mamba2-370m whole, deepseek-moe-16b at 3 of 28 layers,
               zamba2-7b at 24 of 81, rwkv6-7b at 8 of 32, mixtral-8x7b
               at 2 of 32 (memory: 16 bytes per float32 param to train,
               each line names the full size): losses, grad norms, step
               ms, tok/s, ``mfu``, peak over the base; the card against
               the CPU at 2 layers (zamba2: one super-block) on the same
               params and batch (loss rtol 1e-5, grad norm 1e-4); then
               ``launch.train --arch mamba2-370m``; no kernel runs;
 19. contiguous — the contiguous cache (``LM.prefill`` / ``init_cache``
               / ``decode_step``) in float32: llama3.2-1b at full width,
               prefill 4 x 256 then 32 decode steps against ``forward``
               (3e-3 / 6e-3), int8 K/V decoding 32 tokens against
               ``forward`` (rel < 0.05), 2 layers card against CPU
               (1e-4); qwen2-vl-7b whole after a multimodal prefill (64
               patch embeds, 64 text tokens), 8 decode steps against
               ``forward``; mixtral-8x7b at 2 layers, a 5120-token prompt
               through its 4096-slot window ring, 8 decode steps against
               ``forward`` (8e-3); no kernel runs;
 20. steps   — ``launch/steps.py`` with ``materialize``d inputs:
               llama3.2-1b's train_4k (batch 1), prefill_32k (batch 1)
               and decode_32k (batch 8, its cache filled to 32767
               tokens), then zamba2-7b whole in long mode, one long_500k
               decode step against a 4096-slot ring filled to 524287
               tokens: ms and peak memory of each; no kernel runs;
 17a. expert_parallel — (after hubert) deepseek-moe-16b at full width,
               4 of 28 layers, dropless, its MoE expert-parallel on a
               (1,1) mesh of the NCCL group: one layer against
               ``moe_apply`` (2e-4), then greedy sweeps in paged and
               tree mode with expert parallelism off and on, equal
               trees, every attention kernel launched, the all_to_all
               calls counted;
 20a. dryrun — ``python -m repro_torch.launch.dryrun`` (one process per
               combo, started before train_families at the lowest CPU
               priority with no GPU visible, collected after steps):
               llama3.2-1b on the four shapes on the (16,16) and
               (2,16,16) fake meshes (long_500k the policy's skip) and
               deepseek-moe-16b's train_4k on the expert-parallel path;
               every record ``ok`` or that skip, per-device peak GB and
               the roofline terms, then ``analysis.report``'s tables; no
               kernel runs and the card's memory does not move;
 21. replay  — each kernel against its plain version on the largest
               inputs the main path gave it (the sampler's: the sampled
               searches' largest draw, tokens bit for bit), timed (CUDA
               events, L2 flushed between launches; ``ms`` with the
               host's enqueue time, ``device_ms`` without, see
               ``Timer``) beside its bound and, for prefill, one
               ``scaled_dot_product_attention`` call as a yardstick (the
               port never calls it), also at three shapes off the main
               path; the paged and tree kernels also at each
               pages-per-split of a sweep, the paged kernel also beside
               the bound of the logical bytes its rows stream;

the example and serve phases hold the largest call of each kernel they
ran against its plain version; every flash call on a float32 bucket of
1024 tokens or more (parity phase, streamed and swap paths) is also held
to the same function in float64 (``ORACLE_RATIO``). Then the kernels
line ``{"kernels": [...]}`` (``launches``: the sum over the paths driven
with the counts zeroed just before each — the main sweep in both modes,
the sampled sweeps, the mesh sweeps and mesh serve, the flash and dense
prefills and the dense sweeps, streamed, swap, both serving runs, the
replica runs, train, example, serve, each family's sweeps and swap
round, the VLM's sweeps, its forward and hubert's, the expert-parallel
sweeps, the families' training, the contiguous cache, the steps and the
dry run — ``launches_by_path`` each path's) and, last, the device line.
After each phase a ``seconds`` line gives its wall time.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FLOP/s per input type (float32 on the CUDA cores, bf16 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
# and per second of its 132 SMs at the 1.98 GHz those peaks assume: 64
# int32 lanes an SM, and the float64 pipe's 33.5 TFLOP/s as one add,
# multiply or FMA per lane
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_FP64_OPS = 33.5e12 / 2
# the sampler's kernel, per element of the logits: int32 operations of
# threefry2x32 (20 rounds of add, rotate and xor; 5 key injections of
# two adds; the counter's add) and of the bits and the uniform (xor,
# shift, or); float64 operations of its two logs, each a subtract, a
# multiply and an add around log1p, whose path for arguments in [-0.5,
# 0) is ~25 float64 operations in the kernel's SASS (sm_90a, CUDA 12.8)
GUMBEL_INT32_OPS = 20 * 3 + 5 * 2 + 1 + 3
GUMBEL_FP64_OPS = 2 * (3 + 25)

# tolerances of the reference's own kernel tests (tests/test_kernels.py)
TOL = {("paged_attention", "float32"): 2e-5,
       ("tree_attention", "float32"): 3e-5,
       ("flash_prefill", "float32"): 2e-5}
TOL_BF16 = 2e-2
# bf16 on the long paged tables: the kernel and the plain version both
# compute in fp32 and round once to bf16, so each element is held to the
# fp32 tolerance plus two bf16 ulps of its value (2 * 2**-7 relative);
# 2e-2 is near a typical output of rows this long and would not see a
# dropped page
RTOL_BF16_ROUNDED = 2 * 2 ** -7
# flash prefill on long buckets (float32, LONG_BUCKET tokens and more):
# kernel and plain version are both held to the same function in
# float64, and the kernel may be no farther from it than the tolerance
# and than ORACLE_RATIO times the plain version
LONG_BUCKET = 1024
ORACLE_RATIO = 2.0
LONG_SCALED = 3.0       # the long buckets again, q and k scaled up
# paged vs tree decode logits at full width: both float32, summed in
# another order over 16 layers; logits are O(1)
TOL_MODES = 2e-3
# sampled decode: where the modes draw different tokens, the two
# candidates' perturbed logits may differ by no more than this (the
# modes' logits differ by ~1e-5, the noise by a few ulp)
TOL_SAMPLED_GAP = 1e-4

# jax 0.9.0's answers (jax_threefry_partitionable on), which the port's
# sampler must give exactly
KNOWN_SPLIT_0_2 = [[1797259609, 2579123966], [928981903, 3453687069]]
KNOWN_FOLD_IN_0_3 = [2467461003, 3840466878]
KNOWN_BITS_0_4 = [4070199207, 4202968722, 1427181096, 2012915765]
KNOWN_CATEGORICAL = {0: 73608, 7: 96183}      # seed -> index, zeros(V)

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


def paged_long_inputs(torch, np, rng, dtype, H=32, K=8, hd=64, S=16, P=512,
                      T=160):
    """Block tables that span many splits at every pages-per-split of
    the sweep: (pages, length) per row, -1 entries inside tables, a row
    sharing 100 prefix pages with row 0, a -1-only stretch of 8 entries,
    rows ending mid-page and mid-split, a zero-length row and one-page
    rows."""
    rows = [(160, 160 * S - 5), (130, 130 * S - 9), (0, 0), (1, 7),
            (1, S), (37, 37 * S - 1), (129, 129 * S - 3), (64, 64 * S)]
    B = len(rows)
    bt = np.full((B, T), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b, (n, length) in enumerate(rows):
        bt[b, :n] = rng.choice(P, n, replace=False)
        lens[b] = length
    bt[6, :100] = bt[0, :100]
    bt[1, 3:130:7] = -1
    bt[7, 8:16] = -1
    mk = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.normal(size=shape), dtype=dtype, device="cuda")
    return (mk(B, H, hd), mk(P, S, K, hd), mk(P, S, K, hd),
            torch.as_tensor(bt, device="cuda"),
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

def paged_slots(args):
    """(valid slots per unique page, (row, slot) pairs attended) of a
    paged call."""
    _, kp, _, bt, lens = args
    S = kp.shape[1]
    bt_h, lens_h = bt.cpu().numpy(), lens.cpu().numpy()
    uniq = {}        # page -> valid slots the function must read once
    row_tok = 0
    for b in range(bt_h.shape[0]):
        n = int(lens_h[b])
        for t in range(min(-(-n // S), bt_h.shape[1])):
            pg = int(bt_h[b, t])
            if pg >= 0:
                valid = min(S, n - t * S)
                row_tok += valid
                uniq[pg] = max(uniq.get(pg, 0), valid)
    return uniq, row_tok


def paged_work(args, scale):
    q, kp, _, bt, lens = args
    B, H, hd = q.shape
    _, S, K, _ = kp.shape
    el = q.element_size()
    uniq, row_tok = paged_slots(args)
    kv = sum(uniq.values()) * K * hd * 2 * el
    nbytes = kv + 2 * q.numel() * el + bt.numel() * 4 + lens.numel() * 4
    flops = 4 * row_tok * H * hd
    return nbytes, flops


def paged_logical_bytes(args):
    """The bytes of a paged call when every row streams its own pages
    (a page shared by k rows counted k times)."""
    q, kp, _, bt, lens = args
    _, _, K, hd = kp.shape
    el = q.element_size()
    _, row_tok = paged_slots(args)
    return (row_tok * K * hd * 2 * el + 2 * q.numel() * el
            + bt.numel() * 4 + lens.numel() * 4)


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


def gumbel_call(torch, timer, keys, logits, temperature):
    """One draw of the sampler's kernel (``ops.gumbel_sample``) held
    against its plain version (``sampler.gumbel_argmax``) bit for bit
    and timed: ``ms`` / ``device_ms`` beside the plain version's
    ``plain_ms`` and the bound of the draw's bytes (logits read once,
    keys and tokens), int32 and float64 operations."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sampler
    R, V = logits.shape
    got = ops.gumbel_sample(keys, logits, temperature)
    want = sampler.gumbel_argmax(keys, logits, temperature)
    differ = int((got.long() != want).sum())
    n = R * V
    nbytes = n * logits.element_size() + R * (8 + 4)
    times = {"bytes": nbytes / PEAK_BYTES,
             "int32": n * GUMBEL_INT32_OPS / PEAK_INT32_OPS,
             "float64": n * GUMBEL_FP64_OPS / PEAK_FP64_OPS}
    by = max(times, key=times.get)
    out = {"rows": R, "vocab": V, "dtype": str(logits.dtype),
           "temperature": temperature, "tokens_differ": differ,
           "ms": timer.ms(lambda: ops.gumbel_sample(keys, logits,
                                                    temperature)),
           "device_ms": timer.device_ms(lambda: ops.gumbel_sample(
               keys, logits, temperature)),
           "plain_ms": timer.ms(lambda: sampler.gumbel_argmax(
               keys, logits, temperature), reps=5),
           "bound_ms": times[by] * 1e3, "bound_by": by, "bytes": nbytes,
           "int32_ops": n * GUMBEL_INT32_OPS,
           "fp64_ops": n * GUMBEL_FP64_OPS,
           "ops_per_element": {"int32": GUMBEL_INT32_OPS,
                               "float64": GUMBEL_FP64_OPS}}
    if differ:
        emit({"phase": "parity", "kernel": "gumbel_sample", **out})
        fail(f"gumbel_sample: {differ} of {R} tokens differ from the plain "
             f"version at {R} x {V} {logits.dtype}, T {temperature}")
    return out


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


@contextlib.contextmanager
def paged_pages_per_split(ops, pps):
    """Run the paged wrapper at ``pps`` block-table entries per split."""
    default = ops.PAGED_PAGES_PER_SPLIT
    ops.PAGED_PAGES_PER_SPLIT = pps
    try:
        yield
    finally:
        ops.PAGED_PAGES_PER_SPLIT = default


def check(name, dtype, out, ref, case, bf16_rounded=False, oracle=None,
          oracle_only=False):
    """|out - ref| <= tol + rtol * |ref| elementwise: tol is the
    reference tests' (rtol 0), or for ``bf16_rounded`` the fp32 tol with
    rtol ``RTOL_BF16_ROUNDED``.  With ``oracle`` (the same function in
    float64), the kernel may also be no farther from it than ``tol`` and
    than ``ORACLE_RATIO`` times the plain version ``ref``; with
    ``oracle_only`` (inputs where the plain version is itself about
    ``tol`` from the oracle) only that bar holds, and the gap to the
    plain version is printed."""
    import torch
    if out.is_cuda:
        torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    tol, rtol = TOL[(name, "float32")], 0.0
    if dtype != torch.float32:
        if bf16_rounded:
            rtol = RTOL_BF16_ROUNDED
        else:
            tol = TOL_BF16
    finite = bool(torch.isfinite(out.float()).all())
    line = {"phase": "parity", "kernel": name, "case": case,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "tol": tol, "rtol": rtol, "finite": finite}
    if oracle is not None:
        err64 = (out.double() - oracle).abs().max().item()
        plain64 = (ref.double() - oracle).abs().max().item()
        line.update(max_abs_err_f64=err64, plain_max_abs_err_f64=plain64,
                    oracle_ratio=ORACLE_RATIO)
    emit(line)
    if not finite or not oracle_only and \
            not bool((diff <= tol + rtol * ref.float().abs()).all()):
        fail(f"{name} ({case}, {dtype}) disagrees with its plain version: "
             f"max_abs_err {err}, tol {tol} + {rtol} x |ref|")
    if oracle is not None and (err64 > tol or err64 > ORACLE_RATIO * plain64):
        fail(f"{name} ({case}): {err64} from the float64 oracle, above "
             f"{tol} or {ORACLE_RATIO} x the plain version's {plain64}")
    return err


def flash_oracle(torch, args, kw):
    """The float64 flash prefill of a call's inputs where it is held to
    one (float32, buckets of ``LONG_BUCKET`` tokens and more), else
    None."""
    from repro_torch.kernels import ref
    q = args[0]
    if q.dtype != torch.float32 or q.shape[1] < LONG_BUCKET:
        return None
    return ref.flash_prefill_f64(*args, **{k: v for k, v in kw.items()
                                           if k in ("scale", "causal",
                                                    "window")})


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
        a = paged_long_inputs(torch, np, rng, dt)
        want = ref.paged_attention_ref(*a, scale=scale)
        for pps in (ops.PAGED_PAGES_PER_SPLIT, 1, 256):
            with paged_pages_per_split(ops, pps):
                out = ops.paged_attention(*a, scale=scale)
                again = ops.paged_attention(*a, scale=scale)
            check("paged_attention", dt, out, want,
                  f"160-page tables, {pps} pages per split, -1 holes, "
                  f"a -1-only stretch, shared prefix, mid-page ends, "
                  f"zero-length and one-page rows", bf16_rounded=True)
            if bool(out[2].ne(0).any()):
                fail("paged_attention: zero-length row is not zero")
            if not torch.equal(out, again):
                fail(f"paged_attention: two launches differ at {pps} pages "
                     f"per split")
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
        if dt == torch.float32:
            # the long buckets of the streamed and swap paths, against
            # the float64 oracle as well
            for S, hd in ((1024, 64), (2048, 64), (1024, 128), (2048, 128)):
                a = flash_inputs(torch, rng, dt, B=2, S=S, hd=hd)
                sc = hd ** -0.5
                check("flash_prefill", dt, ops.flash_prefill(*a, scale=sc),
                      ref.flash_prefill_ref(*a, scale=sc),
                      f"causal, S={S}, hd={hd}, long bucket",
                      oracle=ref.flash_prefill_f64(*a, scale=sc))
                # q and k 3x: scores of std 9, peaked rows (v stays at
                # unit scale, the scale the 2e-5 bar is set for); the
                # plain version comes near 2e-5 of the oracle here itself
                a = [LONG_SCALED * a[0], LONG_SCALED * a[1], a[2]]
                check("flash_prefill", dt, ops.flash_prefill(*a, scale=sc),
                      ref.flash_prefill_ref(*a, scale=sc),
                      f"causal, S={S}, hd={hd}, long bucket, q and k x"
                      f"{LONG_SCALED:g}",
                      oracle=ref.flash_prefill_f64(*a, scale=sc),
                      oracle_only=True)
                del a
                torch.cuda.empty_cache()
        a = flash_inputs(torch, rng, dt, S=128)
        check("flash_prefill", dt,
              ops.flash_prefill(*a, scale=scale, window=48),
              ref.flash_prefill_ref(*a, scale=scale, window=48),
              "causal, window 48, S=128")
        phase_parity_zamba2(torch, np, rng, dt)
        phase_parity_qwen2_vl(torch, np, rng, dt)


def phase_parity_zamba2(torch, np, rng, dt):
    """The three kernels at zamba2-7b's head shape: H = K = 32 (G = 1),
    hd 112; flash also with a 64-token window, and a float32 bucket of
    1024 tokens against float64."""
    from repro_torch.kernels import ops, ref
    hd = 112
    sc = hd ** -0.5
    head = dict(H=32, K=32, hd=hd)
    a = paged_inputs(torch, np, rng, dt, **head)
    check("paged_attention", dt, ops.paged_attention(*a, scale=sc),
          ref.paged_attention_ref(*a, scale=sc),
          "hd 112, G 1, ragged, -1 padded, one zero-length row",
          bf16_rounded=True)
    a = tree_inputs(torch, np, rng, dt, B=48, problems=6, **head)
    check("tree_attention", dt, ops.tree_attention(*a, scale=sc),
          ref.tree_attention_ref(*a, scale=sc),
          "hd 112, G 1, B=48, shared prefixes, dump entries",
          bf16_rounded=True)
    for S, window in ((256, 0), (256, 64)):
        a = flash_inputs(torch, rng, dt, B=2, S=S, **head)
        check("flash_prefill", dt,
              ops.flash_prefill(*a, scale=sc, window=window),
              ref.flash_prefill_ref(*a, scale=sc, window=window),
              f"hd 112, G 1, causal, S={S}, window {window}")
    if dt == torch.float32:
        a = flash_inputs(torch, rng, dt, B=2, S=LONG_BUCKET, **head)
        check("flash_prefill", dt, ops.flash_prefill(*a, scale=sc),
              ref.flash_prefill_ref(*a, scale=sc),
              f"hd 112, G 1, causal, S={LONG_BUCKET}, long bucket",
              oracle=ref.flash_prefill_f64(*a, scale=sc))
        del a
        torch.cuda.empty_cache()


def phase_parity_qwen2_vl(torch, np, rng, dt):
    """The three kernels at qwen2-vl-7b's head shape: 28 query heads over
    4 kv heads (G = 7, odd and not a power of two), hd 128: the paged
    kernel over ragged and 160-page tables, the tree kernel over 32 rows
    (in float32 their state needs two leaf chunks), flash on a bucket
    that is not a multiple of the tile and on the sweep's, and a float32
    bucket of 1024 tokens against float64."""
    from repro_torch.kernels import ops, ref
    hd = 128
    sc = hd ** -0.5
    head = dict(H=28, K=4, hd=hd)
    a = paged_inputs(torch, np, rng, dt, **head)
    check("paged_attention", dt, ops.paged_attention(*a, scale=sc),
          ref.paged_attention_ref(*a, scale=sc),
          "hd 128, G 7, ragged, -1 padded, one zero-length row",
          bf16_rounded=True)
    a = paged_long_inputs(torch, np, rng, dt, **head)
    check("paged_attention", dt, ops.paged_attention(*a, scale=sc),
          ref.paged_attention_ref(*a, scale=sc),
          "hd 128, G 7, 160-page tables, -1 holes, shared prefix",
          bf16_rounded=True)
    a = tree_inputs(torch, np, rng, dt, B=32, problems=4, **head)
    lb = ops.tree_leaves_per_cta(a[0], a[1], a[3].shape[0])
    check("tree_attention", dt, ops.tree_attention(*a, scale=sc),
          ref.tree_attention_ref(*a, scale=sc),
          f"hd 128, G 7, B=32 ({lb} leaves per CTA), shared prefixes, "
          f"dump entries", bf16_rounded=True)
    for S in (100, 256):
        a = flash_inputs(torch, rng, dt, B=2, S=S, **head)
        check("flash_prefill", dt, ops.flash_prefill(*a, scale=sc),
              ref.flash_prefill_ref(*a, scale=sc),
              f"hd 128, G 7, causal, S={S}")
    if dt == torch.float32:
        a = flash_inputs(torch, rng, dt, B=2, S=LONG_BUCKET, **head)
        check("flash_prefill", dt, ops.flash_prefill(*a, scale=sc),
              ref.flash_prefill_ref(*a, scale=sc),
              f"hd 128, G 7, causal, S={LONG_BUCKET}, long bucket",
              oracle=ref.flash_prefill_f64(*a, scale=sc))
        del a
        torch.cuda.empty_cache()


class Recorder:
    """Keeps a copy of the largest call each kernel wrapper received on
    the main path, for the replay phase.  Decode calls are sized only at
    KV layer 0 (one host sync per decode step, not one per layer):
    ``layer0_ptr`` names the running engine's pool.  Each engine built
    while the recorder is entered sets it; a path that runs an engine
    built before sets it by hand.  A call made while a CUDA graph is
    being captured runs nothing and is not sized (sizing syncs): the
    decode forward's calls are seen at each graph key's eager first
    run."""

    def __init__(self, ops):
        self.ops = ops
        self.best = {}
        self.layer0_ptr = None      # the running engine's pool.k base
        self.orig = {n: getattr(ops, n) for n in
                     ("paged_attention", "tree_attention", "flash_prefill")}

    def _wrap(self, name, size_fn, decode):
        orig = self.orig[name]

        def wrapper(*args, **kw):
            import torch
            if (not decode or args[1].data_ptr() == self.layer0_ptr) \
                    and not (args[0].is_cuda and
                             torch.cuda.is_current_stream_capturing()):
                size = size_fn(args)
                if size > self.best.get(name, (-1,))[0]:
                    self.best[name] = (size, [a.clone() for a in args], {
                        k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in kw.items()})
            return orig(*args, **kw)
        return wrapper

    def __enter__(self):
        from repro_torch.serving.engine import PagedEngine
        self.engine_init = engine_init = PagedEngine.__init__
        recorder = self

        def init(engine, *args, **kw):
            engine_init(engine, *args, **kw)
            recorder.layer0_ptr = engine.pool.k.data_ptr()

        PagedEngine.__init__ = init
        self.ops.paged_attention = self._wrap(
            "paged_attention", lambda a: int(a[4].sum()), True)
        self.ops.tree_attention = self._wrap(
            "tree_attention",
            lambda a: int((a[4].sum(1) * a[5]).sum()), True)
        self.ops.flash_prefill = self._wrap(
            "flash_prefill", lambda a: a[0].shape[0] * a[0].shape[1], False)
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.engine import PagedEngine
        PagedEngine.__init__ = self.engine_init
        for n, f in self.orig.items():
            setattr(self.ops, n, f)


def check_recorded(recorder, path):
    """Hold the largest call each kernel wrapper received on ``path``
    (kept by ``recorder``) against its plain version, at the parity
    phase's tolerances.  These launches are not counted to the path."""
    from repro_torch.kernels import ref
    if not recorder.best:
        fail(f"{path}: no kernel call was recorded")
    import torch
    for name, (_, args, kw) in sorted(recorder.best.items()):
        plain = getattr(ref, name + "_ref")
        check(name, args[0].dtype, recorder.orig[name](*args, **kw),
              plain(*args, **{k: v for k, v in kw.items()
                              if k in ("scale", "causal", "window")}),
              f"the {path} path's largest call, shapes "
              f"{[list(a.shape) for a in args]}", bf16_rounded=True,
              oracle=flash_oracle(torch, args, kw)
              if name == "flash_prefill" else None)


def make_backend(models, dev, ecfg=None, bcfg=None):
    """An ``LMBackend`` over ``models`` with its own engine: the main
    path's engine and backend configs, ``ecfg`` / ``bcfg`` overriding
    their fields."""
    from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                     PagedEngine)
    (lm, lp), (prm, pp), (emb, ep) = models
    engine = PagedEngine(lm, lp, EngineConfig(**dict(
        dict(n_pages=1024, page_size=16, max_batch=32, max_seq_len=512,
             attention="tree"), **(ecfg or {}))), device=dev)
    return LMBackend(engine, prm, pp, emb, ep, BackendConfig(**dict(
        dict(step_token=LLAMA_VOCAB_NEWLINE, eos_token=LLAMA_VOCAB_EOS,
             max_step_tokens=32, max_depth=8, temperature=0.0),
        **(bcfg or {}))), answer_fn=lambda toks: None, device=dev)


def run_mode(torch, np, mode, models, prompts, recorder=None,
             temperature=0.0, max_steps=3, phase="main", ecfg_over=None,
             bcfg_over=None, info_over=None, dev="cuda"):
    """One ETS sweep over ``prompts`` in attention ``mode``; greedy runs
    keep every decode step's logits (``engine.logits_trace``), and
    ``recorder`` (if given) keeps the largest call of each kernel.
    ``ecfg_over`` / ``bcfg_over`` override the engine / backend configs
    (another model's tokens, the state pool's size), ``info_over`` adds
    keys to the printed line."""
    from repro_torch.core import ETSConfig, SearchConfig, run_search_many
    from repro_torch.kernels import ops
    backend = make_backend(models, dev, dict(
        attention=mode, trace_logits=temperature <= 0, **(ecfg_over or {})),
        dict(temperature=temperature, **(bcfg_over or {})))
    engine = backend.engine
    scfg = SearchConfig(method="ets", width=8, max_steps=max_steps,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                      cluster_threshold=0.2))
    times = {"prefill": 0.0, "decode": 0.0}

    def timed(key, fn):
        def inner(*a, **kw):
            out, secs = timed_s(torch, dev, lambda: fn(*a, **kw))
            times[key] += secs
            return out
        return inner

    engine.prefill_many = timed("prefill", engine.prefill_many)
    engine.decode = timed("decode", engine.decode)
    if recorder is not None:
        recorder.layer0_ptr = engine.pool.k.data_ptr()
    base = fresh_peak(torch, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        results = run_search_many(backend, scfg, prompts)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = launch_counts(ops)
    engine.alloc.check_invariants()
    if engine.alloc.used_pages != 0 or engine.alloc.seqs:
        fail(f"{mode}: {engine.alloc.used_pages} pages still held after "
             f"the problems retired")
    for r in results:
        if len(r.tree.nodes) < 2:
            fail(f"{mode}: a search produced no children")
    info = {
        "phase": phase, "mode": mode, "temperature": temperature,
        "wall_s": wall,
        "launches": launches,
        "prefill_tokens": engine.n_prefill_tokens,
        "prefill_tok_s": engine.n_prefill_tokens / max(times["prefill"],
                                                       1e-9),
        "decoded_tokens": engine.n_decoded_tokens,
        "decode_steps": engine.n_decode_steps,
        "decode_tok_s": engine.n_decoded_tokens / max(times["decode"], 1e-9),
        "unique_pages_streamed": engine.unique_pages_streamed,
        "logical_pages_streamed": engine.logical_pages_streamed,
        "max_memory_allocated": peak_bytes(torch, dev),
        "memory_allocated_at_start": base,
        "n_swap_outs": engine.n_swap_outs,
        "swapped_out_pages": engine.swapped_out_pages,
        "nodes": [len(r.tree.nodes) for r in results],
        **(info_over or {}),
    }
    if getattr(engine, "mesh", None) is not None:
        info.update(mesh=dict(zip(engine.mesh.mesh_dim_names,
                                  engine.mesh.shape)),
                    pool_placements=[str(p) for p in engine.pool_placements],
                    shard_fallbacks=[dataclasses.asdict(f)
                                     for f in engine.shard_fallbacks])
    if engine.state is not None:
        st = engine.state
        info.update(state_pages=st.n_pages, state_page_mib=st.page_bytes
                    / 2 ** 20, state_pool_mib=st.n_pages * st.page_bytes
                    / 2 ** 20, state_peak_pages=st.peak_used,
                    state_pages_in_use_at_end=st.used_pages)
        if st.used_pages or engine.state_of:
            fail(f"{phase} {mode}: {st.used_pages} state pages still held")
    emit(info)
    if engine.n_swap_outs or engine.swapped_out_pages:
        fail(f"{phase} {mode}: the roomy pool demoted a problem: "
             f"{engine.n_swap_outs} swap-outs, {engine.swapped_out_pages} "
             f"pages")
    return results, engine.logits_trace, launches, info


class SampleLog:
    """Keeps every sampling call of the decode streams: the row keys, a
    device copy of the logits and the tokens drawn."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.serving import engine
        self.engine = engine
        self.orig = engine.sample_tokens_rowwise

        def wrapper(keys, logits, temperature):
            tok = self.orig(keys, logits, temperature)
            self.calls.append((np.array(keys), logits.detach().clone(),
                               tok.copy(), temperature))
            return tok
        engine.sample_tokens_rowwise = wrapper
        return self

    def __exit__(self, *exc):
        self.engine.sample_tokens_rowwise = self.orig


def tree_tokens(results):
    return [t for r in results for n in r.tree.nodes
            for t in ((n.payload or {}).get("tokens") or [])]


def token_agreement(res_p, res_t):
    a, b = tree_tokens(res_p), tree_tokens(res_t)
    return sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)


def first_disagreement(calls_a, calls_b):
    """The first draw at which two runs' ``SampleLog`` calls part, as
    ``({call, row, tokens, gap}, draws compared)``, or ``(None, n)``.
    ``gap`` is the larger, over the two runs' logits, of the distance
    between the two candidates' perturbed logits."""
    from repro_torch.serving import sampler
    n_calls = 0
    for (ka, la, ta, temp), (kb, lb, tb, _) in zip(calls_a, calls_b):
        if ka.shape != kb.shape or not np.array_equal(ka, kb):
            break                   # the streams parted at an earlier draw
        n_calls += 1
        rows = np.nonzero(ta != tb)[0]
        if rows.size:
            r = int(rows[0])
            gaps = []
            for logits in (la, lb):
                pert = (logits[r].float() / temp + sampler.gumbel(
                    ka[r:r + 1], logits.shape[1], logits.device)[0])
                gaps.append(abs(float(pert[int(ta[r])] - pert[int(tb[r])])))
            return ({"call": n_calls - 1, "row": r,
                     "tokens": [int(ta[r]), int(tb[r])], "gap": max(gaps)},
                    n_calls)
    return None, n_calls


def check_plain_sampler(torch, np, models, prompts, res_k, calls_k,
                        dev="cuda"):
    """The sampled tree-mode search again with the sampler's plain version
    in the kernel's place: every draw on the same keys and bitwise equal
    logits must give the kernel run's tokens (``res_k`` and ``calls_k``,
    its results and ``SampleLog`` calls)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sampler
    orig = ops.gumbel_sample
    ops.gumbel_sample = lambda keys, logits, temperature: \
        sampler.gumbel_argmax(sampler.as_keys(keys), logits,
                              temperature).to(torch.int32)
    try:
        with SampleLog() as log:
            res, _, _, _ = run_mode(torch, np, "tree", models, prompts,
                                    temperature=1.0, max_steps=2,
                                    phase="sampled_plain", dev=dev)
    finally:
        ops.gumbel_sample = orig
    n_equal = 0
    for (ka, la, ta, _), (kb, lb, tb, _) in zip(calls_k, log.calls):
        if not (np.array_equal(ka, kb) and torch.equal(la, lb)):
            break
        n_equal += 1
        if not np.array_equal(ta, tb):
            fail(f"sampled tree search, draw {n_equal - 1}: the kernel drew "
                 f"{ta.tolist()}, the plain version {tb.tolist()}")
    emit({"phase": "sampled_plain_vs_kernel", "draws": len(log.calls),
          "draws_on_equal_logits": n_equal,
          "same_tree_tokens": tree_tokens(res) == tree_tokens(res_k)})
    if n_equal == 0:
        fail("sampled_plain_vs_kernel: the two searches' first draws saw "
             "different logits")


def phase_sampling(torch, np, models, prompts, timer):
    """The sampler's known answers on the card, its kernel at the cells'
    draws, then a sampled ETS sweep in each attention mode, held against
    each other, and the tree-mode sweep again with the sampler's plain
    version, held to the kernel's draws.  Returns the largest draw
    (keys, logits, temperature) and the sampled sweeps' launches."""
    from repro_torch.serving import sampler
    k0 = sampler.key(0)
    zeros = torch.zeros(1, 128256, device="cuda")
    got = {
        "key(0)": k0.tolist(),
        "split(key(0), 2)": sampler.split(k0, 2).tolist(),
        "fold_in(key(0), 3)": sampler.fold_in(k0, 3).tolist(),
        "bits(key(0), (4,))": sampler.random_bits(
            k0[None], 4, "cuda")[0].cpu().tolist(),
        **{f"categorical(key({seed}), zeros(128256))": int(
            sampler.sample_tokens_rowwise(sampler.key(seed)[None],
                                          zeros)[0])
           for seed in KNOWN_CATEGORICAL},
    }
    want = {
        "key(0)": [0, 0], "split(key(0), 2)": KNOWN_SPLIT_0_2,
        "fold_in(key(0), 3)": KNOWN_FOLD_IN_0_3,
        "bits(key(0), (4,))": KNOWN_BITS_0_4,
        **{f"categorical(key({seed}), zeros(128256))": idx
           for seed, idx in KNOWN_CATEGORICAL.items()},
    }
    emit({"phase": "sampling", "known_answers": got,
          "exact": got == want})
    if got != want:
        fail(f"sampler known answers: got {got}, want {want}")
    # one decode step's draw at the main path's width, host launches and
    # the tokens' copy to the host included
    logits = torch.randn(32, 128256, device="cuda")
    keys = sampler.split(sampler.key(1), 32)
    emit({"phase": "sampler_time", "rows": 32, "vocab": 128256,
          "sampled_ms": timer.ms(lambda: sampler.sample_tokens_rowwise(
              keys, logits, 1.0)),
          "greedy_ms": timer.ms(lambda: sampler.sample_tokens_rowwise(
              keys, logits, 0.0))})
    # the benchmark cells' draws: 256 rows of bf16 logits at qwen2-vl's
    # and deepseek-moe's vocab
    for V in (152064, 102400):
        big = torch.randn(256, V, device="cuda").to(torch.bfloat16)
        emit({"phase": "sampler_kernel", **gumbel_call(
            torch, timer, sampler.split(sampler.key(V), 256), big, 1.0)})
        del big
    runs = {}
    for mode in ("paged", "tree"):
        with SampleLog() as log:
            res, _, launches, info = run_mode(
                torch, np, mode, models, prompts, temperature=1.0,
                max_steps=2, phase="sampled")
        runs[mode] = (res, log.calls, launches, info)
    if not (runs["paged"][2]["paged_attention"]
            and runs["tree"][2]["tree_attention"]
            and all(runs[m][2]["flash_prefill"] for m in runs)):
        fail(f"a kernel of the path did not launch in the sampled runs: "
             f"{[runs[m][2] for m in runs]}")
    first, n_calls = first_disagreement(runs["paged"][1], runs["tree"][1])
    if n_calls == 0:
        fail("the sampled runs drew with different keys from the start")
    emit({"phase": "sampled_modes",
          "token_agreement": token_agreement(runs["paged"][0],
                                             runs["tree"][0]),
          "draws_compared": n_calls, "first_disagreement": first,
          "tol_gap": TOL_SAMPLED_GAP,
          "decode_tok_s": {m: runs[m][3]["decode_tok_s"] for m in runs}})
    if first is not None and first["gap"] > TOL_SAMPLED_GAP:
        fail(f"sampled paged and tree decode part at a gap of "
             f"{first['gap']} > {TOL_SAMPLED_GAP}: {first}")
    for mode, (res, _, _, _) in runs.items():
        kids = {tuple((n.payload or {}).get("tokens") or ())
                for n in res[0].tree.nodes[1:]}
        if len(kids) < 2:
            fail(f"sampled {mode} search drew one branch only")
    check_plain_sampler(torch, np, models, prompts, *runs["tree"][:2])
    # the largest draw of the sampled searches: the sampler kernel's
    # main-path call, and the launches of the two searches
    keys, logits, _, temp = max(
        (c for m in runs for c in runs[m][1]),
        key=lambda c: c[1].shape[0] * c[1].shape[1])
    launches = {n: sum(runs[m][2][n] for m in runs) for n in runs["tree"][2]}
    return (keys, logits, temp), launches


def compare_modes(np, res_p, trace_p, res_t, trace_t):
    agree = token_agreement(res_p, res_t)
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


SAMPLER = "gumbel_sample"      # the kernel that is not attention
PLAIN = {"paged_attention": "paged_attention_ref",
         "tree_attention": "tree_attention_ref",
         "flash_prefill": "flash_prefill_ref"}
WORK = {"paged_attention": paged_work, "tree_attention": tree_work,
        "flash_prefill": flash_work}


def tree_chunks(ops, args, kw):
    """How the tree kernel cut a call's batch (``ops.tree_leaves_per_cta``)
    and the K/V bytes its split pass then streams: each leaf chunk reads
    the pages some leaf of the chunk needs, so a page shared across
    chunks is read once per chunk (``kv_bytes_read``), against
    ``kv_bytes_once`` when every unique page is read once.  None on the
    CPU (the plain version runs there)."""
    q, kp, _, pl, pm, plen = args
    if not q.is_cuda:
        return None
    # the grid covers every entry; the live ones lead, counted on the
    # device when the call passed its count
    n = kw.get("n_live")
    n = pl.shape[0] if n is None else int(n.item())
    lb = ops.tree_leaves_per_cta(q, kp, pl.shape[0],
                                 pages_per_split=kw.get("pages_per_split"))
    B = q.shape[0]
    mask = pm[:n].cpu().numpy().astype(bool)
    lens = plen[:n].cpu().numpy().astype(np.int64)
    slot = kp.shape[2] * kp.shape[3] * 2 * kp.element_size()
    read = sum(int(lens[mask[:, c:c + lb].any(axis=1)].sum())
               for c in range(0, B, lb))
    return {"rows": B, "leaves_per_cta": lb, "leaf_chunks": -(-B // lb),
            "kv_bytes_once": int(lens[mask.any(axis=1)].sum()) * slot,
            "kv_bytes_read": read * slot}


def replay_call(torch, name, args, kw, fn, timer, case):
    """One recorded call of kernel ``name`` (wrapper ``fn``) held against
    its plain version and timed: kernel ``ms`` / ``device_ms``, the
    plain version's ``plain_ms``, the bound of its bytes and FLOPs, and
    for prefill one SDPA call (``library_ms``)."""
    from repro_torch.kernels import ref
    plain = getattr(ref, PLAIN[name])
    pkw = {k: v for k, v in kw.items() if k in ("scale", "causal", "window")}
    err = check(name, args[0].dtype, fn(*args, **kw), plain(*args, **pkw),
                case)
    out = {"max_abs_err": err,
           "ms": timer.ms(lambda: fn(*args, **kw)),
           "device_ms": timer.device_ms(lambda: fn(*args, **kw)),
           "plain_ms": timer.ms(lambda: plain(*args, **pkw)),
           "library_ms": None}
    if name == "flash_prefill":
        sdpa = sdpa_call(torch, *args, scale=kw["scale"])
        out["library_ms"] = timer.ms(sdpa)
        out["library_device_ms"] = timer.device_ms(sdpa)
    nbytes, flops = WORK[name](args, kw["scale"])
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops,
                                                args[0].dtype)
    out.update(bytes=nbytes, flops=flops)
    if name == "tree_attention":
        from repro_torch.kernels import ops
        out["tree_leaf_chunks"] = tree_chunks(ops, args, kw)
    return out


def phase_replay(torch, recorder, launches, timer):
    from repro_torch.kernels import ops
    lines = []
    for k in ops.KERNELS:
        if k.name not in recorder.best:
            fail(f"{k.name} never ran on the main path")
        _, args, kw = recorder.best[k.name]
        fn = recorder.orig[k.name]
        if k.name == SAMPLER:
            r = gumbel_call(torch, timer, *args, **kw)
            emit({"phase": "replay", "kernel": k.name, **r})
            lines.append({"name": k.name, "route": "cuda",
                          "source": k.source, "replaces": k.replaces,
                          "launches": launches[k.name],
                          "tokens_differ": r["tokens_differ"],
                          **{n: r[n] for n in ("ms", "device_ms", "plain_ms",
                                               "bound_ms", "bound_by")},
                          "library_ms": None})
            continue
        r = replay_call(torch, k.name, args, kw, fn, timer,
                        "main-path inputs")
        extra = {}
        if k.name == "paged_attention":
            # as for the tree kernel below, over block-table entries
            extra["pages_per_split_default"] = ops.PAGED_PAGES_PER_SPLIT
            sweep = {}
            for pps in (1, 2, 4, 8, 16, 32):
                with paged_pages_per_split(ops, pps):
                    sweep[pps] = timer.device_ms(lambda: fn(*args, **kw))
            extra["device_ms_by_pages_per_split"] = sweep
            # every row streams its own pages: the bytes when L2 serves
            # no re-read of a shared page
            extra["logical_bytes"] = paged_logical_bytes(args)
            extra["logical_bound_ms"] = \
                extra["logical_bytes"] / PEAK_BYTES * 1e3
        if k.name == "tree_attention":
            # pages per split trades CTAs (parallelism) and partials for
            # the combine against the length of each CTA's page stream
            extra["pages_per_split_default"] = ops.TREE_PAGES_PER_SPLIT
            extra["device_ms_by_pages_per_split"] = {
                pps: timer.device_ms(lambda: fn(*args, **dict(
                    kw, pages_per_split=pps)))
                for pps in (1, 2, 4, 8, 16, 32)}
        if k.name == "flash_prefill":
            extra["off_path"] = flash_off_path(torch, timer)
        shapes = [list(a.shape) for a in args]
        emit({"phase": "replay", "kernel": k.name, "shapes": shapes,
              "dtype": str(args[0].dtype), **r, **extra})
        lines.append({"name": k.name, "route": "cuda", "source": k.source,
                      "replaces": k.replaces, "launches": launches[k.name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "device_ms": r["device_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
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
                    f"off-path timing, B={B}, S={S}, hd={hd}",
                    oracle=flash_oracle(torch, a, {"scale": scale}))
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
          # the tree kernel's two launches: its split pass and the
          # combine pass it shares with the paged kernel (tree mode only
          # runs here)
          "tree_attention_ms_per_step": sum(
              ms for name, (ms, _) in by_name.items()
              if name.startswith(("void tree_",
                                  "void split_combine_kernel"))) / steps,
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


def phase_main(torch, np, timer):
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
    (keys, logits, temp), sampled = phase_sampling(torch, np, models,
                                                   prompts, timer)
    recorder.best[SAMPLER] = (logits.numel(), [keys, logits],
                              {"temperature": temp})
    recorder.orig[SAMPLER] = ops.gumbel_sample
    phase_profile(torch, models, prompts)
    return recorder, {"main": launches, "sampled": sampled}, models, \
        prompts, {"paged": res_p, "tree": res_t}


# ---------------------------------------------------------------------------
# slice 4: streamed prefill, swap, the online serving loop
# ---------------------------------------------------------------------------

# streamed vs one-shot prefill at full width: K/V of a 2048-token prompt
TOL_STREAMED_KV = 1e-3
LONG_PROMPT = 2048
PREFILL_CHUNK = 512
HOST_LINK_GBS = 64.0    # PCIe Gen5 x16, nominal, per direction


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def timed_s(torch, dev, fn):
    """(result, seconds) of ``fn()``, synchronised around it."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def event_ms(torch, dev, fn):
    """(result, ms) of ``fn()`` between two CUDA events on the current
    stream (host clock on the CPU)."""
    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def fresh_peak(torch, dev="cuda"):
    """Free what earlier work left to the collector (engines hold
    reference cycles), return the cached blocks and reset the peak;
    returns the bytes still allocated, the base a peak is read over (0
    on the CPU)."""
    gc.collect()
    if torch.device(dev).type != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def peak_reset(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()
    return 0


def peak_bytes(torch, dev):
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def launch_counts(ops):
    return {k.name: k.launches for k in ops.KERNELS}


def seq_kv(engine, sid):
    """Per-layer (K, V) of a sequence's context, cloned."""
    h = engine.alloc.seqs[sid]
    return [tuple(t.clone() for t in engine.pool.gather_kv(
        l, h.block_table, h.length)) for l in range(engine.pool.n_layers)]


def phase_streamed(torch, models, prompt, smi, dev="cuda"):
    """One long prompt prefilled one-shot (flash kernel, one bucket) and
    streamed in ``PREFILL_CHUNK``-token segments: K/V per layer, the
    last-token logits and the 8-token greedy continuation must agree."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    n_pages = -(-(len(prompt) + 64) // 16) + 8
    runs, cont = {}, {}
    recorder = Recorder(ops)
    ops.reset_launch_counts()
    with recorder:
        for name, chunk in (("one_shot", None), ("streamed", PREFILL_CHUNK)):
            engine = PagedEngine(lm, lp, EngineConfig(
                n_pages=n_pages, page_size=16, max_batch=8,
                max_seq_len=len(prompt) + 64, attention="paged",
                trace_logits=True, prefill_chunk_tokens=chunk), device=dev)
            engine.free(engine.prefill(prompt))       # warm-up, untimed
            engine.reset_counters()
            base = peak_reset(torch, dev)
            sid, secs = timed_s(torch, dev, lambda: engine.prefill(prompt))
            peak = peak_bytes(torch, dev)
            runs[name] = dict(secs=secs, peak=peak, base=base,
                              calls=engine.n_prefill_calls,
                              logits=engine.logits_trace[-1],
                              kv=seq_kv(engine, sid))
            cont[name] = engine.decode([sid], 8, key=0,
                                       temperature=0.0)[sid]
    launches = launch_counts(ops)
    one, st = runs["one_shot"], runs["streamed"]
    kv_gap = [max(float((a - b).abs().max()) for a, b in zip(x, y))
              for x, y in zip(one["kv"], st["kv"])]
    kv_max = [max(float(t.abs().max()) for t in x) for x in one["kv"]]
    logit_gap = float(np.abs(one["logits"] - st["logits"]).max())
    ctx = len(prompt) - 1
    emit({"phase": "streamed", "nvidia_smi": smi, "prompt_tokens":
          len(prompt), "chunk": PREFILL_CHUNK,
          "prefill_calls": {n: r["calls"] for n, r in runs.items()},
          "max_abs_kv_gap_by_layer": kv_gap, "tol_kv": TOL_STREAMED_KV,
          "max_abs_kv_by_layer": kv_max,
          "last_logits_max_abs_gap": logit_gap,
          "prefill_tok_s": {n: ctx / r["secs"] for n, r in runs.items()},
          "prefill_s": {n: r["secs"] for n, r in runs.items()},
          "max_memory_allocated": {n: r["peak"] for n, r in runs.items()},
          "peak_over_base_bytes": {n: r["peak"] - r["base"]
                                   for n, r in runs.items()},
          "continuation": cont, "launches": launches})
    if st["calls"] != -(-ctx // PREFILL_CHUNK) or one["calls"] != 1:
        fail(f"streamed prefill ran {st['calls']} segments, one-shot "
             f"{one['calls']} calls")
    if max(kv_gap) > TOL_STREAMED_KV:
        fail(f"streamed K/V differ from one-shot by {max(kv_gap)}")
    if cont["one_shot"] != cont["streamed"]:
        fail(f"greedy continuations differ: {cont}")
    if not (launches["flash_prefill"] and launches["paged_attention"]):
        fail(f"a kernel of the streamed phase did not launch: {launches}")
    # the one-shot 2048-token bucket and the decode over its 128+ pages
    check_recorded(recorder, "streamed")
    return launches


def swap_round(torch, engine, every, dev):
    """Swap ``every`` (one namespace) out, prefill a filler over exactly
    the freed pages, resolve the host copy, swap back in, free the
    filler; fail unless the K/V come back bitwise.  Returns the round's
    sizes and times: ``swap_out_ms`` spans the snapshot and the host's
    bookkeeping and pinned allocation (CUDA events on the compute
    stream), ``d2h_copy_ms`` the copy alone (events on the side
    stream), ``swap_in_ms`` the host-to-device copy plus the scatter."""
    ns = engine.alloc.seqs[every[0]].ns
    before = {s: seq_kv(engine, s) for s in every}
    n, out_ms = event_ms(torch, dev, lambda: engine.swap_out(every))
    (stale, gather), = engine._spill[ns]
    filler = engine.prefill(list(range(1000, 1000 + 16 * n)))
    if sorted(engine.alloc.seqs[filler].block_table) != sorted(stale):
        fail("the filler did not reuse the freed pages")
    _, resolve_ms = event_ms(torch, dev, gather.resolve)
    got, in_ms = event_ms(torch, dev, lambda: engine.swap_in(every))
    if got != n:
        fail(f"swap_in restored {got} of {n} pages")
    for s in every:
        for (k0, v0), (k1, v1) in zip(before[s], seq_kv(engine, s)):
            if not (torch.equal(k0, k1) and torch.equal(v0, v1)):
                fail(f"sequence {s}: restored K/V differ")
    engine.free(filler)
    gb = 2 * engine.pool.k[:, :n].numel() * engine.pool.k.element_size() \
        / 1e9
    copy_ms = gather.copy_ms()
    return {"pages": n, "mib": gb * 1e9 / 2 ** 20, "swap_out_ms": out_ms,
            "resolve_ms": resolve_ms, "d2h_copy_ms": copy_ms,
            "d2h_gb_s": gb / (copy_ms / 1e3) if copy_ms else None,
            "swap_in_ms": in_ms, "h2d_scatter_gb_s": gb / (in_ms / 1e3),
            "pinned": all(t.is_pinned() for t in gather._host_t)}


def phase_swap(torch, models, prompt, smi, dev="cuda"):
    """One problem in paged mode (a prompt, 8 branches, 32 decoded tokens
    each) swapped out whole, its freed pages overwritten by a filler's
    prefill, then swapped back in, twice (the first round allocates the
    pinned buffers, the second reuses them from the caching host
    allocator): bitwise equal pages, the same next 8 greedy tokens as a
    twin engine that never swapped."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    ecfg = EngineConfig(n_pages=160, page_size=16, max_batch=8,
                        max_seq_len=1024, attention="paged")
    outs, rounds = [], []
    recorder = Recorder(ops)
    ops.reset_launch_counts()
    with recorder:
        for swap in (False, True):
            engine = PagedEngine(lm, lp, ecfg, device=dev)
            sid = engine.prefill(prompt)
            ids = engine.branch(sid, 8)
            engine.decode(ids, 32, key=0, temperature=0.0)
            if swap:
                rounds = [swap_round(torch, engine, [sid] + ids, dev)
                          for _ in range(2)]
            outs.append([engine.decode(ids, 8, key=0, temperature=0.0)[i]
                         for i in ids])
            engine.alloc.check_invariants()
    launches = launch_counts(ops)
    emit({"phase": "swap", "nvidia_smi": smi, "prompt_tokens": len(prompt),
          "branches": 8, "decoded_tokens_per_branch": 32,
          "rounds": rounds, "host_link_gb_s_nominal": HOST_LINK_GBS,
          "next_tokens_equal": outs[0] == outs[1], "launches": launches})
    if outs[0] != outs[1]:
        fail("decode after swap differs from the twin that never swapped")
    if torch.device(dev).type == "cuda" and not all(r["pinned"]
                                                    for r in rounds):
        fail("the spill buffer is not pinned host memory")
    if not (launches["paged_attention"] and launches["flash_prefill"]):
        fail(f"a kernel of the swap phase did not launch: {launches}")
    # 8 rows over 18-19 pages each, and the filler's prefill bucket
    check_recorded(recorder, "swap")
    return launches


class MarginLog:
    """Per decoded token, keyed by (seq id, position): the row's top-2
    logits (values and ids), and the seconds spent in decode steps."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.top = {}
        self.decode_s = 0.0

    def __enter__(self):
        from repro_torch.serving import engine as engine_mod
        self.mod = engine_mod
        self.orig_sample = engine_mod.sample_tokens_rowwise
        self.orig_step = engine_mod.DecodeStream.step
        log, torch = self, self.torch

        def sample(keys, logits, temperature):
            v, i = torch.topk(logits.float(), 2, dim=-1)
            log._last = (v.cpu().numpy(), i.cpu().numpy())
            return log.orig_sample(keys, logits, temperature)

        def step(stream):
            rows = list(stream._slot_seq)
            eng = stream.engine
            pos = {i: len(eng.tokens[i]) for i in rows if i is not None}
            sync(torch, log.dev)
            t0 = time.perf_counter()
            out = log.orig_step(stream)
            sync(torch, log.dev)
            log.decode_s += time.perf_counter() - t0
            v, ix = log._last
            for j, i in enumerate(rows):
                if i is not None:
                    log.top[(i, pos[i])] = (v[j], ix[j])
            return out

        engine_mod.sample_tokens_rowwise = sample
        engine_mod.DecodeStream.step = step
        return self

    def __exit__(self, *exc):
        self.mod.sample_tokens_rowwise = self.orig_sample
        self.mod.DecodeStream.step = self.orig_step


def serving_agreement(res_a, log_a, res_b, log_b):
    """Token agreement of two runs' trees, and at the first disagreeing
    token the larger, over the runs, of the gap between the two
    candidates' logits (None where a candidate is not in a row's top 2)."""
    n_same = n_all = 0
    first = None
    for r, (a, b) in enumerate(zip(res_a, res_b)):
        for na, nb in zip(a.tree.nodes, b.tree.nodes):
            ta = (na.payload or {}).get("tokens") or []
            tb = (nb.payload or {}).get("tokens") or []
            n_all += max(len(ta), len(tb))
            n_same += sum(x == y for x, y in zip(ta, tb))
            if first is not None or ta == tb:
                continue
            t = next((k for k, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     min(len(ta), len(tb)))
            pos, node = t, na
            while node.parent is not None:
                node = a.tree.node(node.parent)
                pos += node.n_tokens
            gaps = []
            for nd, log in ((na, log_a), (nb, log_b)):
                v, ix = log.top.get((nd.payload["seq_id"], pos),
                                    (None, None))
                cand = {int(i): float(x) for x, i in zip(v, ix)} \
                    if v is not None else {}
                pair = [ta[t] if t < len(ta) else None,
                        tb[t] if t < len(tb) else None]
                gaps.append(abs(cand[pair[0]] - cand[pair[1]])
                            if all(p in cand for p in pair) else None)
            first = {"request": r, "node": na.id, "token": t,
                     "tokens": [ta[t] if t < len(ta) else None,
                                tb[t] if t < len(tb) else None],
                     "gap": max((g for g in gaps if g is not None),
                                default=None)}
    return n_same / max(n_all, 1), first


def measure_stage_costs(torch, models, prompt, dev="cuda"):
    """Seconds of one tree-mode decode iteration (8 rows), one PRM call
    (8 rows x 512-token bucket), one embedder call (8 steps of 32
    tokens) and one prefill (``prompt``), each after a warm-up."""
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), (prm, pp), (emb, ep) = models
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=256, page_size=16, max_batch=32, max_seq_len=1024,
        attention="tree"), device=dev)
    engine.free(engine.prefill(prompt))
    sid, prefill_s = timed_s(torch, dev, lambda: engine.prefill(prompt))
    ids = engine.branch(sid, 8)
    engine.decode(ids, 2, key=0, temperature=0.0)
    steps0 = engine.n_decode_steps
    _, dec_s = timed_s(torch, dev, lambda: engine.decode(
        ids, 8, key=0, temperature=0.0))
    decode_iter_s = dec_s / (engine.n_decode_steps - steps0)
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, 128000, (8, 512)), device=dev)
    prm_p = prm.cast_params(pp)
    emb_p = emb.cast_params(ep)
    prm.reward(prm_p, {"tokens": toks})
    _, score_s = timed_s(torch, dev, lambda: prm.reward(
        prm_p, {"tokens": toks}))
    etoks = toks[:, :32].remainder(emb.cfg.vocab_size)
    emb.hidden(emb_p, {"tokens": etoks})
    _, embed_s = timed_s(torch, dev, lambda: emb.hidden(
        emb_p, {"tokens": etoks}))
    return {"decode_iter_s": decode_iter_s, "score_s": score_s,
            "embed_s": embed_s, "prefill_s": prefill_s}


SERVING_PAGES = 224      # the long problem alone holds ~128 + 8 x 3


def serving_prompts(long_prompt):
    rng = np.random.default_rng(2)
    short = [list(map(int, rng.integers(0, 128000, int(n))))
             for n in rng.integers(128, 257, 7)]
    return short[:2] + [long_prompt] + short[2:]


def serving_ecfg(prompts, n_pages=SERVING_PAGES):
    """The serving runs' engine: ``n_pages`` pages, room for the longest
    prompt and its search, long prompts streamed."""
    return dict(n_pages=n_pages, attention="tree",
                max_seq_len=max(len(p) for p in prompts) + 256,
                prefill_chunk_tokens=PREFILL_CHUNK)


def run_serving(torch, models, prompts, costs, refill, dev="cuda",
                n_pages=SERVING_PAGES, recorder=None):
    """Serve ``prompts`` as Poisson requests through ``ServingLoop`` on a
    pool of ``n_pages``, in tree mode with streamed long prompts;
    ``recorder`` (if given) keeps the largest call of each kernel."""
    from repro_torch.core import (ETSConfig, SearchConfig, ServingConfig,
                                  ServingLoop, poisson_requests)
    from repro_torch.kernels import ops
    backend = make_backend(models, dev, serving_ecfg(prompts, n_pages))
    engine = backend.engine
    scfg = SearchConfig(method="ets", width=8, max_steps=3,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                      cluster_threshold=0.2))
    reqs = poisson_requests(prompts, rate=0.05, seed=0, priorities=[0, 1],
                            deadline_slack=300)
    loop = ServingLoop(backend, scfg, reqs, max_live=4,
                       cfg=ServingConfig.from_stage_costs(costs,
                                                          refill=refill))
    if recorder is not None:
        recorder.layer0_ptr = engine.pool.k.data_ptr()
    ops.reset_launch_counts()
    with MarginLog(torch, dev) as log, \
            recorder or contextlib.nullcontext():
        results, wall = timed_s(torch, dev, loop.run)
    launches = launch_counts(ops)
    return loop, engine, results, wall, launches, log


def phase_serving(torch, models, long_prompt, smi, dev="cuda"):
    """Requests arriving over time at a server whose pool is too small:
    refill, then lock-step; every request finishes, problems are demoted
    to pinned host memory and restored, the pool drains.  Returns the
    launches and the measured stage costs."""
    costs = measure_stage_costs(torch, models, long_prompt[:256], dev)
    prompts = serving_prompts(long_prompt)
    emit({"phase": "stage_costs", "nvidia_smi": smi, **costs})
    from repro_torch.kernels import ops
    runs, total = {}, {}
    recorder = Recorder(ops)
    for refill in (True, False):
        loop, engine, results, wall, launches, log = run_serving(
            torch, models, prompts, costs, refill, dev,
            recorder=recorder if refill else None)
        report = loop.slo.report()
        name = "refill" if refill else "lockstep"
        emit({"phase": "serving", "nvidia_smi": smi, "mode": name,
              "n_pages": engine.ecfg.n_pages, "requests": len(prompts),
              "slo": report, "clock": loop.clock, "wall_s": wall,
              "decode_s": log.decode_s,
              "decode_tok_s": engine.n_decoded_tokens / max(log.decode_s,
                                                           1e-9),
              "decoded_tokens": engine.n_decoded_tokens,
              "decode_steps": engine.n_decode_steps,
              "prefill_calls": engine.n_prefill_calls,
              "n_swap_outs": engine.n_swap_outs,
              "swapped_out_pages": engine.swapped_out_pages,
              "swapped_in_pages": engine.swapped_in_pages,
              "demotions": loop.stats.demotions,
              "unique_pages_streamed": engine.unique_pages_streamed,
              "logical_pages_streamed": engine.logical_pages_streamed,
              "launches": launches})
        if len(results) != len(prompts) or \
                report["n_finished"] != len(prompts):
            fail(f"{name}: {report['n_finished']} of {len(prompts)} "
                 f"requests finished")
        if not (engine.n_swap_outs >= 1 and engine.swapped_out_pages
                == engine.swapped_in_pages > 0):
            fail(f"{name}: no demotion, or not every page restored: "
                 f"{engine.n_swap_outs} swap-outs, "
                 f"{engine.swapped_out_pages} out, "
                 f"{engine.swapped_in_pages} in")
        if engine.alloc.used_pages or engine.alloc.swapped_pages:
            fail(f"{name}: {engine.alloc.used_pages} pages held and "
                 f"{engine.alloc.swapped_pages} parked at the end")
        engine.alloc.check_invariants()
        if not (launches["tree_attention"] and launches["flash_prefill"]):
            fail(f"{name}: a kernel of the path did not launch: {launches}")
        runs[name] = (results, log, report)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    # the tree kernel's longest page lists so far (a shared prefix of
    # ~128 pages under 8 leaves) and the largest prefill bucket
    check_recorded(recorder, "serving")
    agree, first = serving_agreement(runs["refill"][0], runs["refill"][1],
                                     runs["lockstep"][0],
                                     runs["lockstep"][1])
    emit({"phase": "serving_modes", "nvidia_smi": smi,
          "token_agreement": agree,
          "first_disagreement": first,
          "p99_tta": {n: runs[n][2]["p99_tta"] for n in runs}})
    return total, costs


# ---------------------------------------------------------------------------
# slice 5: training at full width, the trained example, the serve launcher
# ---------------------------------------------------------------------------

# one full-width training step at depth 2, card against the CPU
RTOL_TRAIN_LOSS = 1e-5
RTOL_TRAIN_GNORM = 1e-4
TRAIN_STEPS = 6
TRAIN_BATCH = 32
TRAIN_SEQ = 64          # ArithmeticTask(seq_len=64), as launch.train
# the example's bars: the reference's test_trained_e2e_ets_beats_chance
# (2 of 10, twice chance) and test_lm_short_fit (last loss < 0.75 x first)
EXAMPLE_MIN_CORRECT = 2
EXAMPLE_LOSS_DROP = 0.75


class StepLog:
    """The train loop's ``on_step`` hook: the global grad norm AdamW
    clipped with at each step, and the time at the end of each step
    (CUDA events on the card, the host clock on the CPU; the first mark
    is taken when the log is made)."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.marks, self.norms = [], []
        self._mark()

    def _mark(self):
        torch = self.torch
        if torch.device(self.dev).type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def __call__(self, i, loss, gnorm):
        self.norms.append(gnorm)
        self._mark()

    def step_ms(self):
        if not isinstance(self.marks[0], float):
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def train_flops(model, params, batch, seq):
    """Model FLOPs of one training step: 6 x params x tokens for the
    products with the weights, plus the attention scores and sums (the
    plain path computes all seq x seq of them), forward and backward."""
    from repro_torch.models.model import tree_leaves
    cfg = model.cfg
    n = sum(p.numel() for p in tree_leaves(params))
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 6 * n * batch * seq + 3 * attn, n


def train_on_cpu_and_device(torch, np, dev, arch):
    """One training step of ``arch`` at depth 2 (batch 4) on ``dev`` and
    on the CPU from the same params and batch: the loss and the global
    grad norm must agree (TF32 or a device-dependent op would show)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, tree_leaves, tree_map
    from repro_torch.training import TrainConfig, train_lm
    from repro_torch.training.task import VOCAB_SIZE, ArithmeticTask
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              vocab_size=max(VOCAB_SIZE, 32),
                              dtype="float32")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    task = ArithmeticTask(n_ops=3, seq_len=TRAIN_SEQ)
    out = {}
    for d in (dev, "cpu"):
        log = StepLog(torch, d)
        trained, hist = train_lm(
            build_model(cfg, device=d),
            tree_map(lambda a: a.to(d), params), task,
            TrainConfig(steps=1, batch=4, log_every=1), on_step=log)
        out[d] = (hist[0], float(log.norms[0]), tree_leaves(trained))
    (loss_d, norm_d, p_d), (loss_c, norm_c, p_c) = out[dev], out["cpu"]
    row = {"device": str(dev), "loss": [loss_d, loss_c],
           "grad_norm": [norm_d, norm_c],
           "loss_rel_diff": abs(loss_d - loss_c) / abs(loss_c),
           "grad_norm_rel_diff": abs(norm_d - norm_c) / abs(norm_c),
           "params_max_abs_diff_after_step": max(
               float((a.cpu() - b).abs().max()) for a, b in zip(p_d, p_c)),
           "rtol_loss": RTOL_TRAIN_LOSS, "rtol_grad_norm": RTOL_TRAIN_GNORM}
    if row["loss_rel_diff"] > RTOL_TRAIN_LOSS or \
            row["grad_norm_rel_diff"] > RTOL_TRAIN_GNORM:
        fail(f"a training step on {dev} differs from the CPU's: {row}")
    return row


def phase_train(torch, np, smi, dev="cuda", arch="llama3.2-1b"):
    """``repro_torch.launch.train``'s model at ``arch`` width (float32,
    the task's 32-token vocabulary) trained for a few steps, then the
    same config with a value head through ``train_prm``; a bitwise
    checkpoint round trip; one step at depth 2 against the CPU.  The
    training path runs no kernel of the port (the reference trains
    through plain attention): its launch counts are read to show it."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import tree_leaves
    from repro_torch.training import TrainConfig, checkpoint, train_lm, \
        train_prm
    from repro_torch.training.task import ArithmeticTask
    start = fresh_peak(torch, dev)
    task = ArithmeticTask(n_ops=3, seq_len=TRAIN_SEQ)
    ops.reset_launch_counts()
    rows = {}
    for name, fit, vh, seed in (("lm", train_lm, False, 0),
                                ("prm", train_prm, True, 1)):
        base = fresh_peak(torch, dev)
        model, params = launch_train.model_and_params(
            arch, with_value_head=vh, seed=seed, device=dev)
        log = StepLog(torch, dev)
        params, hist = fit(model, params, task, TrainConfig(
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, log_every=1),
            on_step=log)
        ms = log.step_ms()
        norms = [float(n) for n in log.norms]
        peak = peak_bytes(torch, dev)
        flops, n_params = train_flops(model, params, TRAIN_BATCH,
                                      TRAIN_SEQ)
        steady = float(np.mean(ms[1:]))
        rows[name] = {
            "params": n_params, "losses": hist, "grad_norms": norms,
            "step_ms": ms, "warmup_step_ms": ms[0], "mean_step_ms": steady,
            "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
            "tok_s": TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3),
            "flops_per_step": flops,
            "mfu": flops / (steady / 1e3) / PEAK_FLOPS["torch.float32"],
            "memory_allocated_before": base, "max_memory_allocated": peak,
            "peak_over_base_bytes": peak - base}
        if not (np.all(np.isfinite(hist)) and np.all(np.isfinite(norms))):
            fail(f"train {name}: non-finite loss or grad norm: {hist}, "
                 f"{norms}")
        if name == "lm":
            with tempfile.TemporaryDirectory() as d:
                path = str(Path(d) / "lm.npz")
                _, save_s = timed_s(torch, dev,
                                    lambda: checkpoint.save(path, params))
                back, load_s = timed_s(torch, dev,
                                       lambda: checkpoint.load(path, params))
            same = all(a.device == b.device and torch.equal(a, b)
                       for a, b in zip(tree_leaves(params),
                                       tree_leaves(back)))
            rows[name].update(checkpoint_bitwise=same,
                              checkpoint_save_s=save_s,
                              checkpoint_load_s=load_s)
            del back
            if not same:
                fail("the checkpoint did not load back bitwise")
        del model, params
    launches = launch_counts(ops)
    emit({"phase": "train", "nvidia_smi": smi, "arch": arch,
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "memory_allocated_at_start": start,
          "peak_flops_fp32": PEAK_FLOPS["torch.float32"], **rows,
          "launches": launches})
    emit({"phase": "train_cpu_vs_card", "nvidia_smi": smi,
          **train_on_cpu_and_device(torch, np, dev, arch)})
    return launches


def load_example():
    """``examples/torch_train_and_search.py`` as a module."""
    path = ROOT / "examples" / "torch_train_and_search.py"
    spec = importlib.util.spec_from_file_location("torch_train_and_search",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_example(torch, smi, dev="cuda", argv=()):
    """The train-then-search example at its defaults (``argv`` adds to
    them) on ``dev``: tiny LM + PRM trained 400 steps each on the
    arithmetic task, REBASE and ETS over 10 problems (width 12, paged
    mode, page size 8, G = 2)."""
    from repro_torch.kernels import ops
    example = load_example()
    base = fresh_peak(torch, dev)
    recorder = Recorder(ops)
    ops.reset_launch_counts()
    with recorder:
        (rows, info), wall = timed_s(torch, dev, lambda: example.main(
            ["--device", str(dev), *argv]))
    launches = launch_counts(ops)
    peak = peak_bytes(torch, dev)
    lm_hist = info["lm_history"]
    for r in rows:
        emit({"phase": "example", "nvidia_smi": smi, "method": r["method"],
              "accuracy": r["accuracy"], "n_correct": r["n_correct"],
              "avg_physical_pages": r["avg_physical_pages"],
              "avg_logical_pages": r["avg_logical_pages"],
              "sharing": r["avg_logical_pages"]
              / max(r["avg_physical_pages"], 1e-9),
              "wall_s": r["wall_s"]})
    emit({"phase": "example_train", "nvidia_smi": smi,
          "lm_loss_first": lm_hist[0], "lm_loss_last": lm_hist[-1],
          "prm_loss_first": info["prm_history"][0],
          "prm_loss_last": info["prm_history"][-1],
          "train_s": info["train_s"], "wall_s": wall,
          "memory_allocated_at_start": base, "max_memory_allocated": peak,
          "launches": launches})
    ets = next(r for r in rows if r["method"] == "ets")
    if ets["n_correct"] < EXAMPLE_MIN_CORRECT:
        fail(f"example: ETS solved {ets['n_correct']} problems, below "
             f"{EXAMPLE_MIN_CORRECT}")
    if not lm_hist[-1] < EXAMPLE_LOSS_DROP * lm_hist[0]:
        fail(f"example: LM loss {lm_hist[0]} -> {lm_hist[-1]}, not below "
             f"{EXAMPLE_LOSS_DROP} x the first")
    if not (launches["paged_attention"] and launches["flash_prefill"]):
        fail(f"example: a kernel of the path did not launch: {launches}")
    check_recorded(recorder, "example")
    return launches


def phase_serve(torch, smi, dev="cuda", argv=(), path="serve"):
    """``repro_torch.launch.serve``'s main path on ``dev``: a tiny LM +
    PRM trained 100 steps, 8 Poisson requests served in tree mode (page
    size 8, G = 2); ``argv`` adds to the arguments (``--replicas 2``:
    one arrival stream over two engines, ``path`` then names it)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    base = fresh_peak(torch, dev)
    recorder = Recorder(ops)
    ops.reset_launch_counts()
    loop_s = []
    loops = (serve.ServingLoop, serve.ReplicaServingLoop)
    orig_runs = [cls.run for cls in loops]

    def timed(orig):
        def run(loop):
            out, secs = timed_s(torch, dev, lambda: orig(loop))
            loop_s.append(secs)
            return out
        return run

    for cls, orig in zip(loops, orig_runs):
        cls.run = timed(orig)
    try:
        with recorder:
            out, wall = timed_s(torch, dev, lambda: serve.main(
                ["--requests", "8", "--train-steps", "100", "--device",
                 str(dev), *argv]))
    finally:
        for cls, orig in zip(loops, orig_runs):
            cls.run = orig
    launches = launch_counts(ops)
    engines = [b.engine for b in out["backends"]]
    rep, results, answers = out["report"], out["results"], out["answers"]
    acc = sum(int(r.answer == a) for r, a in zip(results, answers)) \
        / len(answers)
    emit({"phase": "serve", "path": path, "nvidia_smi": smi,
          "requests": len(answers), "replicas": len(engines),
          "slo": rep, "accuracy": acc, "wall_s": wall,
          "serve_wall_s": loop_s[0],
          "routed": getattr(out["loop"], "routed", None),
          "decoded_tokens": [e.n_decoded_tokens for e in engines],
          "decode_steps": [e.n_decode_steps for e in engines],
          "unique_pages_streamed": [e.unique_pages_streamed
                                    for e in engines],
          "logical_pages_streamed": [e.logical_pages_streamed
                                     for e in engines],
          "memory_allocated_at_start": base,
          "max_memory_allocated": peak_bytes(torch, dev),
          "launches": launches})
    if len(results) != 8 or rep["n_finished"] != 8:
        fail(f"{path}: {rep['n_finished']} of 8 requests finished")
    for e in engines:
        if e.alloc.used_pages or e.alloc.swapped_pages:
            fail(f"{path}: {e.alloc.used_pages} pages held and "
                 f"{e.alloc.swapped_pages} parked at the end")
        e.alloc.check_invariants()
    if not (launches["tree_attention"] and launches["flash_prefill"]):
        fail(f"{path}: a kernel of the path did not launch: {launches}")
    check_recorded(recorder, path)
    return launches


# ---------------------------------------------------------------------------
# slice 6: the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

# (arch, layers run (None = all), PRM layers, why the depth is cut).
# zamba2-7b runs at full width and depth; the PRM is the same config cut
# to 6 layers (one hybrid super-layer) plus the value head.
FAMILY_RUNS = (
    ("zamba2-7b", None, 6, None),
    ("deepseek-moe-16b", 4, 2,
     "memory: its 28 layers are 67.5 GB in float32 masters"),
    ("mamba2-370m", None, 2, None),
    ("rwkv6-7b", 4, 2,
     "time: 32 layers run the same code as 4, at 8x the smoke's time"),
)
# one state page holds every recurrent layer's state (zamba2-7b: 148.5
# MiB), so the state pool is sized far below the KV pool's 1024 pages:
# 4 problems x (8 leaves + their 8 children) fit (64 pages at the peak)
FAMILY_STATE_PAGES = 96
FAMILY_STEP_TOKEN = 13
FAMILY_EOS_TOKEN = 2
TOL_FAMILY_REWARD = 1e-5


def family_models(torch, arch, n_layers, prm_layers, dev, shrink=None):
    """(LM, PRM, embedder) of ``arch`` with random weights from seeds:
    the LM at ``n_layers`` (None = all), the PRM at ``prm_layers`` with
    a value head (for the VLM a text model of the same width),
    ``tiny-embedder`` at the family's vocab.  ``shrink``
    (a config -> config map) cuts width too, for a rehearsal on the CPU.
    The PRM's float32 masters are dropped once cast (``LMBackend``
    keeps only its compute-type copy)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    full = get_config(arch)
    shrink = shrink or (lambda c: c)
    cfg = shrink(dataclasses.replace(full, n_layers=n_layers or
                                     full.n_layers))
    prm_cfg = shrink(dataclasses.replace(full, n_layers=prm_layers))
    if prm_cfg.arch_type == "vlm":
        # the backend scores text with (B,S) positions: a text PRM of the
        # same width (three equal M-RoPE streams are plain RoPE)
        prm_cfg = dataclasses.replace(prm_cfg, arch_type="dense",
                                      mrope_sections=(), frontend_dim=0)
    emb_cfg = dataclasses.replace(get_config("tiny-embedder"),
                                  vocab_size=cfg.vocab_size)
    models = []
    for i, (c, vh) in enumerate([(cfg, False), (prm_cfg, True),
                                 (emb_cfg, False)]):
        m = build_model(c, with_value_head=vh, device=dev)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        p = m.init(gen)
        if vh:
            p = m.cast_params(p)        # the fp32 masters go here
        models.append((m, p))
    return models


def param_count(tree):
    from repro_torch.models.model import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def same_trees(res_a, res_b):
    """(equal tree structure and tokens, max relative reward gap)."""
    same, worst = True, 0.0
    for a, b in zip(res_a, res_b):
        va = [(n.parent, n.depth, n.n_tokens, n.finished,
               (n.payload or {}).get("tokens")) for n in a.tree.nodes]
        vb = [(n.parent, n.depth, n.n_tokens, n.finished,
               (n.payload or {}).get("tokens")) for n in b.tree.nodes]
        same = same and va == vb and len(res_a) == len(res_b)
        if va == vb:
            ra, rb = (np.array([np.nan if n.reward is None else n.reward
                                for n in r.tree.nodes], np.float64)
                      for r in (a, b))
            ok = np.isfinite(ra) & np.isfinite(rb)
            if ok.any():
                worst = max(worst, float((np.abs(ra - rb)[ok] / np.maximum(
                    np.abs(ra[ok]), 1e-30)).max()))
    return same, worst


def state_page(engine, sid):
    pg = engine.state_of[sid]
    return {n: a[:, pg].clone() for n, a in engine.state.arrays.items()}


def family_swap_round(torch, models, prompt, smi, dev):
    """One live problem (a prompt, 4 branches, 16 tokens each) swapped
    out, both pools dirtied by a filler (its prefill reuses the freed KV
    pages and a freed state page), swapped back in: every KV page and
    every state page must come back bitwise, and decode resumes."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=256, page_size=16, max_batch=8, max_seq_len=512,
        attention="paged", n_state_pages=8), device=dev)
    recorder = Recorder(ops)
    ops.reset_launch_counts()
    with recorder:
        recorder.layer0_ptr = engine.pool.k.data_ptr()
        sid = engine.prefill(prompt)
        ids = [sid] + engine.branch(sid, 4)
        engine.decode(ids[1:], 16, key=0, temperature=0.0)
        kv = {s: seq_kv(engine, s) for s in ids}
        st = {s: state_page(engine, s) for s in ids}
        n, out_ms = event_ms(torch, dev, lambda: engine.swap_out(ids))
        ns = engine.alloc.seqs[sid].ns
        (_, sgather), = engine._state_spill[ns]
        filler = engine.prefill(prompt[::-1])
        engine.decode([filler], 2, key=0, temperature=0.0)
        _, resolve_ms = event_ms(torch, dev, sgather.resolve)
        got, in_ms = event_ms(torch, dev, lambda: engine.swap_in(ids))
        engine.free(filler)
        kv_ok = all(torch.equal(a, b) for s in ids
                    for x, y in zip(kv[s], seq_kv(engine, s))
                    for a, b in zip(x, y))
        st_ok = all(torch.equal(st[s][k], v) for s in ids
                    for k, v in state_page(engine, s).items())
        nxt = engine.decode(ids[1:], 8, key=0, temperature=0.0)
    launches = launch_counts(ops)
    page_mib = engine.state.page_bytes / 2 ** 20
    emit({"phase": "families_swap", "arch": lm.cfg.name, "nvidia_smi": smi,
          "kv_pages": n, "state_pages": len(ids),
          "kv_mib": 2 * engine.pool.k[:, :n].numel()
          * engine.pool.k.element_size() / 2 ** 20,
          "state_mib": len(ids) * page_mib, "swap_out_ms": out_ms,
          "state_resolve_ms": resolve_ms,
          "state_d2h_copy_ms": sgather.copy_ms(), "swap_in_ms": in_ms,
          "kv_bitwise": kv_ok, "state_bitwise": st_ok,
          "pinned": all(t.is_pinned() for t in sgather._host_t.values())
          if torch.device(dev).type == "cuda" else None,
          "launches": launches})
    if got != n or not kv_ok or not st_ok:
        fail(f"{lm.cfg.name} swap round: {got} of {n} pages back, KV "
             f"bitwise {kv_ok}, state bitwise {st_ok}")
    if not all(len(nxt[i]) == 8 for i in ids[1:]):
        fail(f"{lm.cfg.name}: decode did not resume after the swap")
    engine.alloc.check_invariants()
    check_recorded(recorder, f"families:{lm.cfg.name}:swap")
    return launches


def family_run(torch, np, arch, n_layers, prm_layers, why, smi, dev,
               shrink=None, timer=None, path=None):
    """One family: greedy ETS over 4 seeded prompts (width 8, 3 steps,
    32 tokens per step) in paged and, where the model has attention, in
    tree mode; the two trees must be equal.  Returns the path's launches
    and prints one ``families`` line per mode and a summary; with a
    ``timer``, the path's largest kernel calls are timed beside their
    bounds (``families_replay`` lines).  ``path`` names the path in
    ``launches_by_path`` (default ``families:<arch>``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    path = path or f"families:{arch}"
    base = fresh_peak(torch, dev)
    models = family_models(torch, arch, n_layers, prm_layers, dev, shrink)
    (lm, lp), (prm, pp), (emb, ep) = models
    cfg = lm.cfg
    emit({"phase": "families_model", "arch": arch, "path": path,
          "n_layers": cfg.n_layers, "n_layers_full": get_config(arch).n_layers,
          "depth_cut": why, "d_model": cfg.d_model,
          "head_dim": cfg.head_dim, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "lm_params": param_count(lp),
          "prm_layers": prm.cfg.n_layers, "prm_params": param_count(pp),
          "prm_arch_type": prm.cfg.arch_type, "plan": cfg.layer_plan()})
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
               for n in rng.integers(128, 257, 4)]
    ecfg_over = dict(n_state_pages=FAMILY_STATE_PAGES)
    bcfg_over = dict(step_token=FAMILY_STEP_TOKEN, eos_token=FAMILY_EOS_TOKEN)
    modes = ["paged"] if cfg.is_attention_free else ["paged", "tree"]
    # warm-up, untimed: one-time costs (cuBLAS handles, allocator growth)
    from repro_torch.serving import EngineConfig, PagedEngine
    warm = PagedEngine(lm, lp, EngineConfig(
        n_pages=256, page_size=16, max_batch=8, max_seq_len=512,
        n_state_pages=8), device=dev)
    rows = [b for s in warm.prefill_many(prompts[:2])
            for b in warm.branch(s, 2)]
    warm.decode(rows, 2, key=0, temperature=0.0)
    del warm, rows
    recorder = Recorder(ops)
    runs, launches = {}, {k.name: 0 for k in ops.KERNELS}
    for mode in modes:
        res, _, l_m, info = run_mode(
            torch, np, mode, models, prompts, recorder, phase="families",
            ecfg_over=ecfg_over, bcfg_over=bcfg_over,
            info_over={"arch": arch, "path": path, "nvidia_smi": smi},
            dev=dev)
        runs[mode] = (res, l_m, info)
        for k, v in l_m.items():
            launches[k] += v
    summary = {"phase": "families_summary", "arch": arch, "path": path,
               "modes": modes, "launches": launches}
    if "tree" in runs:
        same, worst = same_trees(runs["paged"][0], runs["tree"][0])
        summary.update(same_tree=same, max_reward_rel_gap=worst,
                       tol_reward=TOL_FAMILY_REWARD)
        if not same or worst > TOL_FAMILY_REWARD:
            emit(summary)
            fail(f"{arch}: paged and tree give different trees ({same}) "
                 f"or rewards ({worst})")
        if not (runs["paged"][1]["paged_attention"]
                and runs["tree"][1]["tree_attention"]
                and launches["flash_prefill"]):
            fail(f"{arch}: a kernel of the path did not launch: {launches}")
    elif any(launches.values()):
        fail(f"{arch} is attention-free, yet kernels launched: {launches}")
    if arch == "zamba2-7b":
        summary["swap_launches"] = family_swap_round(
            torch, models, prompts[0], smi, dev)
    summary["peak_over_phase_base_bytes"] = peak_bytes(torch, dev) - base
    summary["memory_allocated_at_phase_start"] = base
    emit(summary)
    if recorder.best:
        check_recorded(recorder, path)
    for name, (_, args, kw) in sorted(recorder.best.items()):
        if timer is not None:
            emit({"phase": "families_replay", "path": path,
                  "kernel": name, "shapes": [list(a.shape) for a in args],
                  "dtype": str(args[0].dtype), "nvidia_smi": smi,
                  **replay_call(torch, name, args, kw, recorder.orig[name],
                                timer, f"the {path} path's "
                                f"largest call, timed")})
    del models, lm, lp, prm, pp, emb, ep, runs, recorder
    fresh_peak(torch, dev)
    return launches, summary.get("swap_launches")


def phase_families(torch, np, smi, dev="cuda", shrink=None, timer=None):
    """zamba2-7b at full width and depth, then deepseek-moe-16b,
    mamba2-370m and rwkv6-7b at full width (depth cuts printed), each
    freed before the next.  Returns launches per path."""
    by_path = {}
    for arch, n_layers, prm_layers, why in FAMILY_RUNS:
        launches, swap = family_run(torch, np, arch, n_layers, prm_layers,
                                    why, smi, dev, shrink, timer)
        by_path[f"families:{arch}"] = launches
        if swap is not None:
            by_path[f"families:{arch}:swap"] = swap
    return by_path


# ---------------------------------------------------------------------------
# slice 7: the VLM, the audio encoder, engine replicas
# ---------------------------------------------------------------------------

# qwen2-vl-7b's frontend: an 8 x 8 grid of patch embeds (frontend_dim
# 1280) before 64 text tokens, at 2 of its 28 layers in float32, on the
# card and on the CPU (bf16 GEMMs round differently on the two)
VLM_FRONTEND_LAYERS = 2
VLM_GRID = 8
VLM_TEXT = 64
TOL_FRONTEND = 1e-4      # logits of |x| ~ 5, float32 summed in two orders
# the position streams must matter: logits with flat positions differ
MIN_MROPE_EFFECT = 1e-3
# hubert-xlarge: 4 clips of 500 frames (10 s of audio at 50 frames per
# second) at full depth; 2 clips of 200 frames at 2 layers in float32,
# card against CPU
HUBERT_BATCH, HUBERT_FRAMES = 4, 500
HUBERT_CPU_LAYERS = 2
TOL_HUBERT = 1e-4
REPLICAS = 2
REPLICA_PROMPTS = 8
TOL_REPLICA_REWARD = 1e-5


def vlm_frontend_batch(torch, cfg, dev):
    """Patch embeds of a ``VLM_GRID`` x ``VLM_GRID`` image before
    ``VLM_TEXT`` text tokens, with M-RoPE positions: t = 0 and (h, w)
    the grid cell over the patches, all three streams counting on from
    the grid's side over the text."""
    rng = np.random.default_rng(4)
    n_patch = VLM_GRID * VLM_GRID
    embeds = rng.normal(size=(1, n_patch, cfg.frontend_dim))
    toks = rng.integers(0, cfg.vocab_size, (1, VLM_TEXT))
    grid = np.arange(VLM_GRID)
    text = np.arange(VLM_GRID, VLM_GRID + VLM_TEXT)
    streams = (np.zeros(n_patch), np.repeat(grid, VLM_GRID),
               np.tile(grid, VLM_GRID))
    pos = np.stack([np.concatenate([x, text]) for x in streams])[:, None]
    return {"embeds": torch.as_tensor(embeds, dtype=torch.float32,
                                      device=dev),
            "tokens": torch.as_tensor(toks, device=dev),
            "positions": torch.as_tensor(pos, dtype=torch.int32,
                                         device=dev)}


def phase_vlm_frontend(torch, np, smi, dev="cuda", cpu="cpu", shrink=None):
    """``LM.forward`` of qwen2-vl-7b at full width, cut to
    ``VLM_FRONTEND_LAYERS`` layers in float32, on patch embeds with
    distinct t/h/w streams before text: the card's logits against the
    port's CPU run of the same params (``TOL_FRONTEND``), and against
    flat positions (the streams must change the logits)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model, tree_map
    full = get_config("qwen2-vl-7b")
    cfg = (shrink or (lambda c: c))(dataclasses.replace(
        full, n_layers=VLM_FRONTEND_LAYERS, dtype="float32"))
    base = fresh_peak(torch, dev)
    lm = build_model(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(110))
    batch = vlm_frontend_batch(torch, cfg, dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        lm.forward(params, batch)                  # warm-up
        (logits, _), card_s = timed_s(torch, dev,
                                      lambda: lm.forward(params, batch))
        launches = launch_counts(ops)
        flat = dict(batch)
        flat.pop("positions")
        flat_logits, _ = lm.forward(params, flat)
        peak = peak_bytes(torch, dev)
        lm_cpu = build_model(cfg, device=cpu)
        p_cpu = tree_map(lambda a: a.to(cpu), params)
        b_cpu = {k: v.to(cpu) for k, v in batch.items()}
        (want, _), cpu_s = timed_s(torch, cpu,
                                   lambda: lm_cpu.forward(p_cpu, b_cpu))
    got = logits.cpu()
    diff = float((got - want).abs().max())
    effect = float((flat_logits - logits).abs().max())
    S = VLM_GRID * VLM_GRID + VLM_TEXT
    line = {"phase": "vlm_frontend", "nvidia_smi": smi, "arch": full.name,
            "n_layers": cfg.n_layers, "n_layers_full": full.n_layers,
            "depth_cut": "the CPU oracle: 2 full-width layers hold every "
                         "op of the frontend and M-RoPE path",
            "dtype": cfg.dtype, "d_model": cfg.d_model,
            "frontend_dim": cfg.frontend_dim,
            "mrope_sections": list(cfg.mrope_sections),
            "patches": [VLM_GRID, VLM_GRID], "text_tokens": VLM_TEXT,
            "logits_shape": list(got.shape),
            "finite": bool(torch.isfinite(got).all()),
            "max_abs_logit_diff_cpu": diff,
            "max_abs_logit": float(want.abs().max()), "tol": TOL_FRONTEND,
            "max_abs_logit_change_flat_positions": effect,
            "card_s": card_s, "cpu_s": cpu_s,
            "memory_allocated_at_start": base, "max_memory_allocated": peak,
            "launches": launches}
    emit(line)
    if not line["finite"] or tuple(got.shape) != (1, S, cfg.vocab_size):
        fail(f"vlm_frontend: logits of shape {tuple(got.shape)}, finite "
             f"{line['finite']}")
    if diff > TOL_FRONTEND:
        fail(f"vlm_frontend: card and CPU logits differ by {diff} > "
             f"{TOL_FRONTEND}")
    if effect < MIN_MROPE_EFFECT:
        fail(f"vlm_frontend: the M-RoPE streams moved the logits by "
             f"{effect} only")
    if any(launches.values()):
        fail(f"vlm_frontend: LM.forward runs plain attention, yet kernels "
             f"launched: {launches}")
    del lm, params, lm_cpu, p_cpu
    fresh_peak(torch, dev)
    return launches


def phase_hubert(torch, np, smi, dev="cuda", cpu="cpu", shrink=None):
    """hubert-xlarge at full width and depth: ``hidden`` and ``forward``
    on ``HUBERT_BATCH`` clips of ``HUBERT_FRAMES`` frames (bf16 as the
    config says); the paged engine refuses it (no decode path); at
    ``HUBERT_CPU_LAYERS`` layers in float32 the card's hidden states and
    logits against the CPU's (``TOL_HUBERT``).  No kernel runs:
    ``attn_full`` is plain attention, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model, tree_map
    from repro_torch.serving import EngineConfig, PagedEngine
    full = (shrink or (lambda c: c))(get_config("hubert-xlarge"))
    base = fresh_peak(torch, dev)
    lm = build_model(full, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(120))
    gen = torch.Generator(device=dev).manual_seed(121)
    frames = torch.randn((HUBERT_BATCH, HUBERT_FRAMES, full.frontend_dim),
                         generator=gen, device=dev)
    try:
        PagedEngine(lm, params, EngineConfig(n_pages=16, page_size=16,
                                             max_batch=2, max_seq_len=64),
                    device=dev)
        refused = False
    except ValueError as e:
        refused = "no decode path" in str(e)
    ops.reset_launch_counts()
    with torch.no_grad():
        lm.hidden(params, {"embeds": frames})      # warm-up
        hid, hidden_s = timed_s(torch, dev, lambda: lm.hidden(
            params, {"embeds": frames}))
        (logits, _), forward_s = timed_s(torch, dev, lambda: lm.forward(
            params, {"embeds": frames}))
        launches = launch_counts(ops)
        peak = peak_bytes(torch, dev)
        cut = dataclasses.replace(full, n_layers=HUBERT_CPU_LAYERS,
                                  dtype="float32")
        m = build_model(cut, device=dev)
        p = m.init(torch.Generator(device=dev).manual_seed(122))
        f = frames[:2, :200]
        card = (m.hidden(p, {"embeds": f}), m.forward(p, {"embeds": f})[0])
        m_cpu = build_model(cut, device=cpu)
        p_cpu = tree_map(lambda a: a.to(cpu), p)
        host = (m_cpu.hidden(p_cpu, {"embeds": f.to(cpu)}),
                m_cpu.forward(p_cpu, {"embeds": f.to(cpu)})[0])
    diffs = [float((a.cpu() - b).abs().max()) for a, b in zip(card, host)]
    finite = bool(torch.isfinite(hid.float()).all()
                  and torch.isfinite(logits.float()).all())
    n_tok = HUBERT_BATCH * HUBERT_FRAMES
    line = {"phase": "hubert", "nvidia_smi": smi, "arch": full.name,
            "n_layers": full.n_layers, "d_model": full.d_model,
            "n_heads": full.n_heads, "head_dim": full.head_dim,
            "causal": full.causal, "act": full.act, "dtype": full.dtype,
            "frontend_dim": full.frontend_dim, "params": param_count(params),
            "frames": [HUBERT_BATCH, HUBERT_FRAMES],
            "hidden_shape": list(hid.shape),
            "logits_shape": list(logits.shape), "finite": finite,
            "hidden_s": hidden_s, "forward_s": forward_s,
            "frames_per_s": n_tok / max(forward_s, 1e-9),
            "engine_refused": refused,
            "cpu_check": {"n_layers": HUBERT_CPU_LAYERS, "dtype": "float32",
                          "frames": [2, 200],
                          "max_abs_hidden_diff": diffs[0],
                          "max_abs_logit_diff": diffs[1],
                          "tol": TOL_HUBERT},
            "memory_allocated_at_start": base, "max_memory_allocated": peak,
            "launches": launches,
            "note": "attn_full is plain attention in both packages: no "
                    "kernel of the port runs"}
    emit(line)
    if not finite or tuple(hid.shape) != (HUBERT_BATCH, HUBERT_FRAMES,
                                          full.d_model):
        fail(f"hubert: hidden {tuple(hid.shape)}, finite {finite}")
    if not refused:
        fail("hubert: the paged engine did not refuse an encoder")
    if max(diffs) > TOL_HUBERT:
        fail(f"hubert: card and CPU differ by {diffs} > {TOL_HUBERT}")
    if any(launches.values()):
        fail(f"hubert: kernels launched: {launches}")
    del lm, params, m, p, m_cpu, p_cpu
    fresh_peak(torch, dev)
    return launches


def drained(backends, what):
    for b in backends:
        e = b.engine
        e.alloc.check_invariants()
        if e.alloc.used_pages or e.alloc.swapped_pages or e.alloc.seqs:
            fail(f"{what}: {e.alloc.used_pages} pages held, "
                 f"{e.alloc.swapped_pages} parked at the end")


def phase_replicas(torch, np, models, long_prompt, costs, smi, dev="cuda"):
    """``REPLICAS`` engine replicas of the main path's models on the one
    card: ``run_search_many`` over ``REPLICA_PROMPTS`` prompts must give
    the one-replica trees per problem, greedy and sampled (tokens exact,
    rewards within ``TOL_REPLICA_REWARD``), and ``ReplicaServingLoop``
    serves the serving phase's trace with every page back.  Returns the
    replica runs' launches per path."""
    from repro_torch.core import (ETSConfig, ReplicaServingLoop,
                                  SearchConfig, ServingConfig,
                                  poisson_requests, run_search_many)
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, 128000, int(n))))
               for n in rng.integers(128, 257, REPLICA_PROMPTS)]
    by_path = {}
    for name, temperature, steps in (("greedy", 0.0, 3),
                                     ("sampled", 1.0, 2)):
        scfg = SearchConfig(method="ets", width=8, max_steps=steps,
                            ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                          cluster_threshold=0.2))
        runs = {}
        recorder = Recorder(ops)
        for n in (1, REPLICAS):
            with recorder if n > 1 else contextlib.nullcontext():
                backends = [make_backend(models, dev,
                                         bcfg=dict(temperature=temperature))
                            for _ in range(n)]
                fresh_peak(torch, dev)
                ops.reset_launch_counts()
                res, wall = timed_s(torch, dev, lambda: run_search_many(
                    backends if n > 1 else backends[0], scfg, prompts))
                launches = launch_counts(ops)
            drained(backends, f"replicas:{name}")
            runs[n] = (res, wall, launches, [b.engine for b in backends])
            del backends
        same, worst = same_trees(runs[1][0], runs[REPLICAS][0])
        engines = runs[REPLICAS][3]
        emit({"phase": "replicas", "path": f"replicas:{name}",
              "nvidia_smi": smi, "mode": "tree", "temperature": temperature,
              "prompts": len(prompts), "replicas": REPLICAS,
              "same_trees": same, "max_reward_rel_gap": worst,
              "tol_reward": TOL_REPLICA_REWARD,
              "token_agreement": token_agreement(runs[1][0],
                                                 runs[REPLICAS][0]),
              "wall_s": {"one": runs[1][1], "replicas": runs[REPLICAS][1]},
              "launches": {"one": runs[1][2], "replicas": runs[REPLICAS][2]},
              "prefill_calls_by_replica": [e.n_prefill_calls
                                           for e in engines],
              "decoded_tokens_by_replica": [e.n_decoded_tokens
                                            for e in engines],
              "max_memory_allocated": peak_bytes(torch, dev)})
        if not same or worst > TOL_REPLICA_REWARD:
            fail(f"replicas:{name}: {REPLICAS} replicas give other trees "
                 f"({same}) or rewards ({worst}) than one")
        if not all(e.n_decoded_tokens for e in engines):
            fail(f"replicas:{name}: a replica decoded nothing")
        launches = runs[REPLICAS][2]
        if not (launches["tree_attention"] and launches["flash_prefill"]):
            fail(f"replicas:{name}: a kernel of the path did not launch: "
                 f"{launches}")
        check_recorded(recorder, f"replicas:{name}")
        by_path[f"replicas:{name}"] = launches
        del runs, engines
    # the serving phase's trace, one arrival stream over the replicas
    prompts = serving_prompts(long_prompt)
    scfg = SearchConfig(method="ets", width=8, max_steps=3,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                      cluster_threshold=0.2))
    recorder = Recorder(ops)
    with recorder:
        backends = [make_backend(models, dev, serving_ecfg(prompts))
                    for _ in range(REPLICAS)]
        reqs = poisson_requests(prompts, rate=0.05, seed=0,
                                priorities=[0, 1], deadline_slack=300)
        loop = ReplicaServingLoop(backends, scfg, reqs, max_live=4,
                                  cfg=ServingConfig.from_stage_costs(
                                      costs, refill=True))
        ops.reset_launch_counts()
        results, wall = timed_s(torch, dev, loop.run)
        launches = launch_counts(ops)
    engines = [b.engine for b in backends]
    report = loop.slo.report()
    emit({"phase": "replicas_serving", "path": "replicas:serving",
          "nvidia_smi": smi, "requests": len(prompts),
          "replicas": REPLICAS, "n_pages_per_replica": SERVING_PAGES,
          "slo": report, "clock": loop.clock, "wall_s": wall,
          "routed": [loop.routed[i] for i in range(len(prompts))],
          "decoded_tokens": [e.n_decoded_tokens for e in engines],
          "n_swap_outs": [e.n_swap_outs for e in engines],
          "pages_in_use_at_end": [e.alloc.used_pages for e in engines],
          "launches": launches})
    if len(results) != len(prompts) or report["n_finished"] != len(prompts):
        fail(f"replicas:serving: {report['n_finished']} of {len(prompts)} "
             f"requests finished")
    if len(set(loop.routed.values())) != REPLICAS:
        fail(f"replicas:serving: routed to {set(loop.routed.values())}")
    drained(backends, "replicas:serving")
    if not (launches["tree_attention"] and launches["flash_prefill"]):
        fail(f"replicas:serving: a kernel of the path did not launch: "
             f"{launches}")
    check_recorded(recorder, "replicas:serving")
    by_path["replicas:serving"] = launches
    return by_path


# ---------------------------------------------------------------------------
# slice 8: every family trains, the contiguous cache, launch/steps.py
# ---------------------------------------------------------------------------

# (arch, layers trained (None = all)): float32 training holds 16 bytes per
# param (masters, grads, two AdamW moments), so the deeper models are cut
# to what fits one card; each line names its full size
TRAIN_FAMILIES = (("mamba2-370m", None), ("deepseek-moe-16b", 3),
                  ("zamba2-7b", 24), ("rwkv6-7b", 8), ("mixtral-8x7b", 2))
TRAIN_FAMILY_STEPS = 3
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 8, 64
# card vs CPU: 2 layers (zamba2: one super-block of attn_every layers) on
# 2 x 32 tokens, the same params and batch, loss and global grad norm
TRAIN_FAMILY_CPU_BATCH, TRAIN_FAMILY_CPU_SEQ = 2, 32
# contiguous cache, llama3.2-1b at full width in float32: prefill 4 x 256
# tokens, then 32 decode steps, each against forward at the reference's
# bars (tests/test_models.py); at 2 layers the card against the CPU
CONTIG_BATCH, CONTIG_PROMPT, CONTIG_DECODE = 4, 256, 32
TOL_CONTIG_PREFILL, TOL_CONTIG_DECODE, TOL_CONTIG_RING = 3e-3, 6e-3, 8e-3
CONTIG_CPU_LAYERS, CONTIG_CPU_PROMPT, CONTIG_CPU_DECODE = 2, 64, 4
TOL_CONTIG_CPU = 1e-4
# qwen2-vl-7b whole in float32: the vlm_frontend batch (64 patch embeds
# before 64 text tokens), then decode steps
VLM_DECODE = 8
# mixtral-8x7b at 2 layers in float32 with its 4096-token window: the
# blocked attention path takes prompts in 1024-key tiles, so 5120 is the
# shortest prompt past the window; forward runs over 6144 tokens (causal:
# the tokens after the decoded ones change nothing before them).  The
# capacity factor is set to the expert count, dropless as tiny_variant
# has it, so that forward and decode route every replica alike.
RING_LAYERS, RING_PROMPT, RING_FORWARD, RING_DECODE = 2, 5120, 6144, 8
# int8 KV against full precision (the reference's bar)
INT8_BATCH, INT8_STEPS, TOL_INT8_REL = 2, 32, 0.05
# launch/steps.py on one card: (shape, batch cut to); llama3.2-1b as its
# config says (bf16 compute, float32 masters for training)
STEPS_LLAMA = (("train_4k", 1), ("prefill_32k", 1), ("decode_32k", 8))


def train_shape(batch, seq):
    from repro_torch.configs import InputShape
    return InputShape("train_families", seq, batch, "train")


def spec_param_count(cfg):
    """Params of ``cfg`` from its specs (nothing allocated)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import LM, tree_leaves
    specs = steps.params_specs(LM(cfg, device="cpu"), serve=False)
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def loss_and_grad_norm(torch, model, params, batch):
    """(loss, global grad norm) of ``model.loss`` at ``params``."""
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.optimizer import global_norm
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), float(global_norm(list(grads)))


def train_family_cpu_check(torch, cfg, dev, cpu):
    """One loss and grad norm of ``cfg`` cut to 2 layers (a hybrid to one
    super-block) on ``dev`` and on the CPU, the same params and batch."""
    from repro_torch.launch import steps
    from repro_torch.models.model import tree_map
    layers = cfg.attn_every if cfg.arch_type == "hybrid" else 2
    cut = dataclasses.replace(cfg, n_layers=layers)
    shape = train_shape(TRAIN_FAMILY_CPU_BATCH, TRAIN_FAMILY_CPU_SEQ)
    model = steps.build_model_for(cut, shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(131)
    params = model.init(gen)
    batch = steps.materialize(steps.input_specs(cut, shape), dev, gen)
    host_params = tree_map(lambda a: a.to(cpu), params)
    host_batch = {k: v.to(cpu) for k, v in batch.items()}
    card = loss_and_grad_norm(torch, model, params, batch)
    del model, params, batch
    host = loss_and_grad_norm(
        torch, steps.build_model_for(cut, shape, device=cpu), host_params,
        host_batch)
    row = {"n_layers": layers, "tokens": [TRAIN_FAMILY_CPU_BATCH,
                                          TRAIN_FAMILY_CPU_SEQ],
           "loss": [card[0], host[0]], "grad_norm": [card[1], host[1]],
           "loss_rel_diff": abs(card[0] - host[0]) / abs(host[0]),
           "grad_norm_rel_diff": abs(card[1] - host[1]) / abs(host[1]),
           "rtol_loss": RTOL_TRAIN_LOSS, "rtol_grad_norm": RTOL_TRAIN_GNORM}
    if row["loss_rel_diff"] > RTOL_TRAIN_LOSS or \
            row["grad_norm_rel_diff"] > RTOL_TRAIN_GNORM:
        fail(f"{cfg.name}: a training step on {dev} differs from the "
             f"CPU's: {row}")
    return row


def train_family(torch, np, arch, n_layers, smi, dev="cuda", cpu="cpu",
                 shrink=None):
    """``TRAIN_FAMILY_STEPS`` float32 train steps of ``arch`` at full width
    (``n_layers`` of its layers) through ``steps.build_train_step`` (remat
    on, as ``build_model_for`` builds it) on ``TRAIN_FAMILY_BATCH`` x
    ``TRAIN_FAMILY_SEQ`` tokens of its real vocabulary; then the card
    against the CPU at 2 layers.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import adamw_init
    shrink = shrink or (lambda c: c)
    full = shrink(dataclasses.replace(get_config(arch), dtype="float32"))
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    why = None
    if cfg.n_layers != full.n_layers:
        n_full = spec_param_count(full)
        why = (f"memory: {full.n_layers} layers are {n_full:.3g} params, "
               f"{16 * n_full / 1e9:.0f} GB to train in float32")
    shape = train_shape(TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ)
    base = fresh_peak(torch, dev)
    model = steps.build_model_for(cfg, shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(130)
    params = model.init(gen)
    batch = steps.materialize(steps.input_specs(cfg, shape), dev, gen)
    opt = adamw_init(params)
    log = []
    step = steps.build_train_step(model, on_step=lambda l, g: log.append(
        (l, g)))
    ops.reset_launch_counts()
    ms = []
    for _ in range(TRAIN_FAMILY_STEPS):
        (params, opt, _), t = event_ms(torch, dev,
                                       lambda: step(params, opt, batch))
        ms.append(t)
    launches = launch_counts(ops)
    peak = peak_bytes(torch, dev)
    losses = [float(l) for l, _ in log]
    norms = [float(g) for _, g in log]
    n_params = param_count(params)
    del model, params, opt, batch, step, log
    fresh_peak(torch, dev)
    tokens = TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ
    steady = float(np.mean(ms[1:]))
    flops = 3 * cfg.flops_per_token(TRAIN_FAMILY_SEQ) * tokens
    line = {"phase": "train_families", "nvidia_smi": smi, "arch": arch,
            "arch_type": cfg.arch_type, "n_layers": cfg.n_layers,
            "n_layers_full": full.n_layers, "depth_cut": why,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "params": n_params, "dtype": "float32", "remat": True,
            "batch": TRAIN_FAMILY_BATCH, "seq": TRAIN_FAMILY_SEQ,
            "losses": losses, "grad_norms": norms, "step_ms": ms,
            "mean_step_ms_after_first": steady,
            "tok_s": tokens / (steady / 1e3),
            "flops_per_step": flops,
            "mfu": flops / (steady / 1e3) / PEAK_FLOPS["torch.float32"],
            "memory_allocated_before": base,
            "max_memory_allocated": peak, "peak_over_base_bytes": peak - base,
            "launches": launches,
            "cpu_vs_card": train_family_cpu_check(torch, cfg, dev, cpu)}
    emit(line)
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))):
        fail(f"train_families {arch}: non-finite loss or grad norm")
    if any(launches.values()):
        fail(f"train_families {arch}: training runs plain attention, yet "
             f"kernels launched: {launches}")
    fresh_peak(torch, dev)
    return launches


def phase_train_families(torch, np, smi, dev="cuda", cpu="cpu", shrink=None,
                         argv=("--steps", "3", "--batch", "8")):
    """Every family's training (``TRAIN_FAMILIES``), then
    ``launch.train --arch mamba2-370m`` on ``dev``.  Returns the summed
    launches (none: training runs no kernel of the port)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    total = {k.name: 0 for k in ops.KERNELS}
    for arch, n_layers in TRAIN_FAMILIES:
        for k, n in train_family(torch, np, arch, n_layers, smi, dev, cpu,
                                 shrink).items():
            total[k] += n
    base = fresh_peak(torch, dev)
    ops.reset_launch_counts()
    (model, _, hist), wall = timed_s(torch, dev, lambda: launch_train.main(
        ["--arch", "mamba2-370m", *argv, "--device", str(dev)]))
    launches = launch_counts(ops)
    emit({"phase": "train_families_launcher", "nvidia_smi": smi,
          "argv": ["--arch", "mamba2-370m", *argv], "arch": model.cfg.name,
          "n_layers": model.cfg.n_layers, "vocab": model.cfg.vocab_size,
          "remat": model.remat, "losses": hist, "wall_s": wall,
          "memory_allocated_before": base,
          "max_memory_allocated": peak_bytes(torch, dev),
          "launches": launches})
    if not hist or not np.all(np.isfinite(hist)):
        fail(f"launch.train --arch mamba2-370m: losses {hist}")
    for k, n in launches.items():
        total[k] += n
    del model
    fresh_peak(torch, dev)
    return total


def contiguous_run(torch, lm, params, batch, prompt, n_dec, dev):
    """``forward`` over ``batch`` (tokens, and where given patch embeds
    before them and their positions), ``prefill`` of its first ``prompt``
    positions into a cache of ``prompt + n_dec``, then ``n_dec`` decode
    steps on the text tokens after the prompt: the gap of each step's
    logits to forward's at its position, the times, each step's logits
    and the last cache."""
    n_img = batch["embeds"].shape[1] if "embeds" in batch else 0
    text = batch["tokens"]
    first = prompt - n_img                  # the first decoded text token
    head = dict(batch, tokens=text[:, :first])
    if "positions" in batch:
        head["positions"] = batch["positions"][..., :prompt]
    with torch.no_grad():
        full, fwd_ms = event_ms(torch, dev,
                                lambda: lm.forward(params, batch)[0])
        (lg, cache), pre_ms = event_ms(torch, dev, lambda: lm.prefill(
            params, head, prompt + n_dec))
        gaps = [float((lg - full[:, prompt - 1]).abs().max())]
        logits, dec_ms = [lg], []
        for t in range(n_dec):
            tok = text[:, first + t:first + t + 1]
            (lg, cache), ms = event_ms(torch, dev, lambda: lm.decode_step(
                params, tok, cache))
            gaps.append(float((lg - full[:, prompt + t]).abs().max()))
            logits.append(lg)
            dec_ms.append(ms)
        scale = float(full[:, prompt - 1:prompt + n_dec].abs().max())
    return {"prefill_gap": gaps[0], "decode_gap_max": max(gaps[1:]),
            "max_abs_logit": scale, "forward_ms": fwd_ms,
            "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "decode_ms_mean_after_first": float(np.mean(dec_ms[1:]))}, \
        logits, cache


def check_gaps(what, row, tol_decode):
    if row["prefill_gap"] > TOL_CONTIG_PREFILL or \
            row["decode_gap_max"] > tol_decode:
        fail(f"contiguous {what}: prefill / decode differ from forward by "
             f"{row['prefill_gap']} / {row['decode_gap_max']} (bars "
             f"{TOL_CONTIG_PREFILL} / {tol_decode})")


def full_width(torch, arch, dev, seed, shrink=None, **replace):
    """(LM, params) of ``arch`` at full width in float32 (``replace``
    overrides config fields), random weights from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    shrink = shrink or (lambda c: c)
    cfg = shrink(dataclasses.replace(get_config(arch), dtype="float32",
                                     **replace))
    lm = build_model(cfg, device=dev)
    return lm, lm.init(torch.Generator(device=dev).manual_seed(seed))


def contiguous_llama(torch, np, smi, dev, cpu, shrink):
    """llama3.2-1b: prefill + decode against forward; int8 KV against full
    precision; the card against the CPU at 2 layers."""
    from repro_torch.bridge import cache_to_numpy
    from repro_torch.models.model import LM, tree_map
    lm, params = full_width(torch, "llama3.2-1b", dev, 140, shrink)
    gen = torch.Generator(device=dev).manual_seed(141)
    toks = torch.randint(0, lm.cfg.vocab_size,
                         (CONTIG_BATCH, CONTIG_PROMPT + CONTIG_DECODE),
                         generator=gen, device=dev)
    row, _, cache = contiguous_run(torch, lm, params, {"tokens": toks},
                                   CONTIG_PROMPT, CONTIG_DECODE, dev)
    row["cache_k_shape"] = list(cache["groups"][0]["k"].shape)
    del cache
    # int8 K/V from init_cache, one token at a time, against forward
    lm_q = LM(lm.cfg, quant_kv=True, device=dev)
    itoks = toks[:INT8_BATCH, :INT8_STEPS]
    rel, dtypes = {}, {}
    with torch.no_grad():
        full = lm.forward(params, {"tokens": itoks})[0]
        for name, m in (("int8", lm_q), ("fp", lm)):
            cache = m.init_cache(INT8_BATCH, INT8_STEPS)
            k = cache["groups"][0]["k"]
            dtypes[name] = str((k["q"] if isinstance(k, dict) else k).dtype)
            worst = 0.0
            for t in range(INT8_STEPS):
                lg, cache = m.decode_step(params, itoks[:, t:t + 1], cache)
                ref = full[:, t]
                worst = max(worst, float((lg - ref).abs().max()
                                         / (ref.abs().max() + 1e-9)))
            rel[name] = worst
    row["int8"] = {"batch": INT8_BATCH, "steps": INT8_STEPS,
                   "max_rel_logit_err": rel["int8"],
                   "fp_max_rel_logit_err": rel["fp"],
                   "cache_dtypes": dtypes, "tol_rel": TOL_INT8_REL}
    # the card against the CPU at 2 layers
    cut = dataclasses.replace(lm.cfg, n_layers=CONTIG_CPU_LAYERS)
    del lm, lm_q, params, full
    fresh_peak(torch, dev)
    m_dev = LM(cut, device=dev)
    p_dev = m_dev.init(torch.Generator(device=dev).manual_seed(142))
    m_cpu = LM(cut, device=cpu)
    p_cpu = tree_map(lambda a: a.to(cpu), p_dev)
    t = toks[:, :CONTIG_CPU_PROMPT + CONTIG_CPU_DECODE]
    _, lg_dev, c_dev = contiguous_run(torch, m_dev, p_dev, {"tokens": t},
                                      CONTIG_CPU_PROMPT, CONTIG_CPU_DECODE,
                                      dev)
    _, lg_cpu, c_cpu = contiguous_run(torch, m_cpu, p_cpu,
                                      {"tokens": t.to(cpu)},
                                      CONTIG_CPU_PROMPT, CONTIG_CPU_DECODE,
                                      cpu)
    logit_gap = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(lg_dev, lg_cpu))
    a, b = cache_to_numpy(c_dev, m_dev), cache_to_numpy(c_cpu, m_cpu)
    cache_gap = max(float(np.abs(a["groups"][0][k] - b["groups"][0][k]).max())
                    for k in ("k", "v"))
    pos_equal = bool((a["groups"][0]["pos"] == b["groups"][0]["pos"]).all())
    row["cpu_vs_card"] = {"n_layers": CONTIG_CPU_LAYERS,
                          "prompt": CONTIG_CPU_PROMPT,
                          "decode_steps": CONTIG_CPU_DECODE,
                          "max_abs_logit_diff": logit_gap,
                          "max_abs_kv_diff": cache_gap,
                          "positions_equal": pos_equal,
                          "tol": TOL_CONTIG_CPU}
    del m_dev, p_dev, c_dev
    return row


def phase_contiguous(torch, np, smi, dev="cuda", cpu="cpu", shrink=None):
    """The contiguous cache on the card (``LM.prefill`` / ``init_cache`` /
    ``decode_step``): llama3.2-1b (decode against forward, int8 KV, card
    against CPU), qwen2-vl-7b whole after a multimodal prefill, and
    mixtral-8x7b's 4096-slot window ring.  Returns the launches (none:
    the contiguous cache is plain attention, as in the reference)."""
    from repro_torch.kernels import ops
    base = fresh_peak(torch, dev)
    ops.reset_launch_counts()
    llama = contiguous_llama(torch, np, smi, dev, cpu, shrink)
    emit({"phase": "contiguous", "nvidia_smi": smi, "arch": "llama3.2-1b",
          "dtype": "float32", "batch": CONTIG_BATCH,
          "prompt": CONTIG_PROMPT, "decode_steps": CONTIG_DECODE, **llama,
          "tol_prefill": TOL_CONTIG_PREFILL, "tol_decode": TOL_CONTIG_DECODE,
          "max_memory_allocated": peak_bytes(torch, dev),
          "memory_allocated_before": base})
    check_gaps("llama3.2-1b", llama, TOL_CONTIG_DECODE)
    if llama["int8"]["max_rel_logit_err"] > TOL_INT8_REL:
        fail(f"contiguous int8: {llama['int8']}")
    cc = llama["cpu_vs_card"]
    if max(cc["max_abs_logit_diff"], cc["max_abs_kv_diff"]) > \
            TOL_CONTIG_CPU or not cc["positions_equal"]:
        fail(f"contiguous: card and CPU differ: {cc}")
    # qwen2-vl-7b whole: multimodal prefill, then decode
    base = fresh_peak(torch, dev)
    lm, params = full_width(torch, "qwen2-vl-7b", dev, 150, shrink)
    batch = vlm_frontend_batch(torch, lm.cfg, dev)
    # the text counts on from the patches' count, not from the grid's side:
    # a contiguous cache writes each token at the slot of its position, so
    # positions that restart lower would overwrite the prompt (ROADMAP F5)
    n_patch = batch["embeds"].shape[1]
    batch["positions"][:, :, n_patch:] = torch.arange(
        n_patch, n_patch + batch["tokens"].shape[1], dtype=torch.int32,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(151)
    more = torch.randint(0, lm.cfg.vocab_size, (1, VLM_DECODE),
                         generator=gen, device=dev)
    S = batch["positions"].shape[-1]
    start = int(batch["positions"][0, 0, -1]) + 1   # the prefill's next_pos
    after = torch.arange(start, start + VLM_DECODE, dtype=torch.int32,
                         device=dev).expand(3, 1, VLM_DECODE)
    batch = {"embeds": batch["embeds"],
             "tokens": torch.cat([batch["tokens"], more], dim=1),
             "positions": torch.cat([batch["positions"], after], dim=-1)}
    vlm, logits, cache = contiguous_run(torch, lm, params, batch, S,
                                        VLM_DECODE, dev)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    emit({"phase": "contiguous", "nvidia_smi": smi, "arch": "qwen2-vl-7b",
          "dtype": "float32", "n_layers": lm.cfg.n_layers,
          "params": param_count(params),
          "patch_embeds": int(batch["embeds"].shape[1]),
          "prompt_positions": S, "decode_steps": VLM_DECODE,
          "next_pos_after_prefill": start, "finite": finite,
          "next_pos": cache["next_pos"].tolist(), **vlm,
          "tol_prefill": TOL_CONTIG_PREFILL, "tol_decode": TOL_CONTIG_DECODE,
          "max_memory_allocated": peak_bytes(torch, dev),
          "memory_allocated_before": base})
    if not finite or cache["next_pos"].tolist() != [start + VLM_DECODE]:
        fail(f"contiguous qwen2-vl-7b: finite {finite}, next_pos "
             f"{cache['next_pos'].tolist()}")
    check_gaps("qwen2-vl-7b", vlm, TOL_CONTIG_DECODE)
    del lm, params, batch, logits, cache
    # mixtral-8x7b: a prompt past its 4096-token window, through the ring
    base = fresh_peak(torch, dev)
    from repro_torch.configs import get_config
    moe = dataclasses.replace(get_config("mixtral-8x7b").moe,
                              capacity_factor=float(
                                  get_config("mixtral-8x7b").moe.n_experts))
    lm, params = full_width(torch, "mixtral-8x7b", dev, 160, shrink,
                            n_layers=RING_LAYERS, moe=moe)
    window = lm.cfg.sliding_window
    gen = torch.Generator(device=dev).manual_seed(161)
    prompt, forward = (RING_PROMPT, RING_FORWARD) if shrink is None \
        else (96, 128)
    toks = torch.randint(0, lm.cfg.vocab_size, (1, forward), generator=gen,
                         device=dev)
    ring, _, cache = contiguous_run(torch, lm, params, {"tokens": toks},
                                    prompt, RING_DECODE, dev)
    slots = int(cache["groups"][0]["k"].shape[2])
    emit({"phase": "contiguous", "nvidia_smi": smi, "arch": "mixtral-8x7b",
          "dtype": "float32", "n_layers": RING_LAYERS,
          "n_layers_full": get_config("mixtral-8x7b").n_layers,
          "depth_cut": "the smoke's time and memory: 2 full-width layers "
                       "hold the ring, the window mask and the MoE",
          "capacity_factor": lm.cfg.moe.capacity_factor,
          "params": param_count(params), "window": window,
          "prompt": prompt, "forward_tokens": forward,
          "decode_steps": RING_DECODE, "ring_slots": slots, **ring,
          "tol_prefill": TOL_CONTIG_PREFILL, "tol_decode": TOL_CONTIG_RING,
          "max_memory_allocated": peak_bytes(torch, dev),
          "memory_allocated_before": base})
    if slots != window or prompt <= window:
        fail(f"contiguous mixtral: {slots} ring slots for a {window} window, "
             f"prompt {prompt}")
    check_gaps("mixtral-8x7b", ring, TOL_CONTIG_RING)
    del lm, params, cache, toks
    launches = launch_counts(ops)
    if any(launches.values()):
        fail(f"contiguous: the cache runs plain attention, yet kernels "
             f"launched: {launches}")
    fresh_peak(torch, dev)
    return launches


def fill_cache(torch, cache, filled, gen):
    """A decode cache as after ``filled`` tokens: every attention cache
    holds random K/V at the slots of the last positions before ``filled``
    (slot ``pos % C``; a linear cache of C > filled holds them all), and
    ``next_pos`` is ``filled``.  Recurrent states stay zero."""
    def walk(node):
        if isinstance(node, list):
            for x in node:
                walk(x)
        elif isinstance(node, dict) and "pos" in node:
            C = node["pos"].shape[-1]
            n = min(filled, C)
            p = torch.arange(filled - n, filled, device=node["pos"].device)
            node["pos"][..., p % C] = p.to(node["pos"].dtype)
            for k in ("k", "v"):
                node[k].copy_(torch.randn(node[k].shape, generator=gen,
                                          dtype=node[k].dtype,
                                          device=node[k].device))
        elif isinstance(node, dict):
            for x in node.values():
                walk(x)

    walk(cache["groups"])
    cache["next_pos"].fill_(filled)
    return cache


def steps_line(torch, smi, arch, shape, cut, model, ms, base, dev, **kw):
    emit({"phase": "steps", "nvidia_smi": smi, "arch": arch,
          "shape": shape.name, "kind": shape.kind, "seq_len": shape.seq_len,
          "global_batch": shape.global_batch, "batch_on_card": cut,
          "long_mode": model.long_mode, "window": model.window,
          "compute_dtype": str(model.compute_dtype), "ms": ms,
          "memory_allocated_before": base,
          "max_memory_allocated": peak_bytes(torch, dev),
          "peak_over_base_bytes": peak_bytes(torch, dev) - base, **kw})


def phase_steps(torch, np, smi, dev="cuda", shrink=None, shapes=None):
    """``launch/steps.py`` on the card: llama3.2-1b's train_4k, prefill_32k
    and decode_32k steps (inputs from ``materialize`` at a batch cut to
    one card), then zamba2-7b whole in long mode for one long_500k decode
    step against its cache (``init_cache(1, 524288)``: a 4096-slot ring
    per shared attention block).  ``shapes`` overrides the input shapes
    (a rehearsal on the CPU).  Returns the launches (none)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import adamw_init
    shrink = shrink or (lambda c: c)
    shapes = shapes or INPUT_SHAPES
    ops.reset_launch_counts()
    cfg = shrink(get_config("llama3.2-1b"))
    gen = torch.Generator(device=dev).manual_seed(170)
    base = fresh_peak(torch, dev)
    model = steps.build_model_for(cfg, shapes["train_4k"], device=dev)
    params = model.init(gen)
    for name, cut in STEPS_LLAMA:
        shape = shapes[name]
        cs = dataclasses.replace(shape, global_batch=cut)
        batch = steps.materialize(steps.input_specs(cfg, cs), dev, gen)
        if shape.kind == "train":
            opt = adamw_init(params)
            step = steps.build_train_step(model)
            losses, ms = [], []
            for _ in range(2):
                (params, opt, loss), t = event_ms(
                    torch, dev, lambda: step(params, opt, batch))
                losses.append(float(loss))
                ms.append(t)
            steps_line(torch, smi, cfg.name, shape, cut, model, ms, base, dev,
                       losses=losses, remat=model.remat,
                       tok_s=cut * shape.seq_len / (ms[-1] / 1e3))
            if not np.all(np.isfinite(losses)):
                fail(f"steps {name}: losses {losses}")
            del opt, step
            with torch.no_grad():                  # serving from here on
                params = model.cast_params(params)
        elif shape.kind == "prefill":
            (logits, cache), ms = event_ms(torch, dev, lambda: (
                steps.build_prefill_step(model, shape.seq_len)(params,
                                                               batch)))
            k_shape = list(cache["groups"][0]["k"].shape)
            steps_line(torch, smi, cfg.name, shape, cut, model, [ms], base,
                       dev, cache_k_shape=k_shape,
                       next_pos=cache["next_pos"].tolist(),
                       tok_s=cut * shape.seq_len / (ms / 1e3),
                       finite=bool(torch.isfinite(logits).all()))
            if not torch.isfinite(logits).all() or \
                    k_shape[2] != shape.seq_len:
                fail(f"steps {name}: cache {k_shape}")
            del logits, cache
        else:
            cache = fill_cache(torch, steps.materialize(
                steps.cache_specs(model, cs), dev, gen), shape.seq_len - 1,
                gen)
            decode = steps.build_decode_step(model)
            ms = []
            for _ in range(2):
                (logits, cache), t = event_ms(
                    torch, dev, lambda: decode(params, batch, cache))
                ms.append(t)
            steps_line(torch, smi, cfg.name, shape, cut, model, ms, base, dev,
                       cache_k_shape=list(cache["groups"][0]["k"].shape),
                       next_pos=cache["next_pos"].tolist()[:1],
                       finite=bool(torch.isfinite(logits).all()))
            if not torch.isfinite(logits).all():
                fail(f"steps {name}: non-finite logits")
            del logits, cache
        base = fresh_peak(torch, dev)
    del model, params
    # zamba2-7b whole, long mode, one long_500k decode step
    base = fresh_peak(torch, dev)
    shape = shapes["long_500k"]
    cfg = shrink(get_config("zamba2-7b"))
    model = steps.build_model_for(cfg, shape, device=dev)
    params = model.cast_params(model.init(gen))
    cache = fill_cache(torch, steps.materialize(
        steps.cache_specs(model, shape), dev, gen), shape.seq_len - 1, gen)
    slots = int(cache["groups"][0]["attn"]["k"].shape[2])
    batch = steps.materialize(steps.input_specs(cfg, shape), dev, gen)
    decode = steps.build_decode_step(model)
    ms = []
    for _ in range(2):
        (logits, cache), t = event_ms(torch, dev,
                                      lambda: decode(params, batch, cache))
        ms.append(t)
    steps_line(torch, smi, cfg.name, shape, shape.global_batch, model, ms,
               base, dev, ring_slots=slots, n_layers=cfg.n_layers,
               params=param_count(params),
               next_pos=cache["next_pos"].tolist(),
               finite=bool(torch.isfinite(logits).all()))
    if slots != model.window or not torch.isfinite(logits).all():
        fail(f"steps long_500k: {slots} ring slots, window {model.window}")
    del model, params, cache, logits
    launches = launch_counts(ops)
    if any(launches.values()):
        fail(f"steps: plain attention, yet kernels launched: {launches}")
    fresh_peak(torch, dev)
    return launches


# ---------------------------------------------------------------------------
# slice 9: meshes, the dense-prefill oracle, expert parallelism, the dry
# run
# ---------------------------------------------------------------------------

# flash prefill against the dense oracle at llama3.2-1b width: the four
# 128-256-token prompts' last-token logits (float32 over 16 layers)
TOL_DENSE_LOGITS = 2e-5
# expert-parallel MoE against moe_apply (tests/test_mixers.py's 2e-4)
TOL_EP = 2e-4
EP_TOKENS = 256
# deepseek-moe-16b's capacity factor on the expert-parallel path: 8x an
# expert's mean load, which drops nothing at these routes (the layer
# check counts the drops).  The dropless factor, its expert count (as
# the contiguous phase gives mixtral), is 64 here: every expert's buffer
# as long as all the replicas, 16 GB for a PRM bucket
EP_CAPACITY_FACTOR = 8.0
# the dry run's combos: llama3.2-1b on every shape and both meshes (its
# long_500k is the policy's skip), deepseek-moe-16b's train step on the
# expert-parallel path
DRYRUN_COMBOS = tuple(
    ("llama3.2-1b", shape, mp, False)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    for mp in (False, True)) + (("deepseek-moe-16b", "train_4k", False,
                                 True),)
DRYRUN_POLICY_SKIPS = {("llama3.2-1b", "long_500k")}
DRYRUN_TIMEOUT = 900


class TwoDeviceMesh:
    """What ``check_mesh_compat`` reads of a 2-device mesh."""

    def size(self, dim=None):
        return 2


def phase_mesh(torch, np, models, prompts, main_res, smi, dev="cuda"):
    """The main path's greedy ETS sweep on engines placed on a 1-device
    mesh (a world-size-1 NCCL group): the trees must equal the main
    phase's in both modes and every kernel launch; the kernel seam must
    refuse a 2-device mesh; ``launch.serve --mesh 1`` runs to its end.
    Returns launches per path."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import check_mesh_compat
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device=dev)
    recorder = Recorder(ops)
    launches = {k.name: 0 for k in ops.KERNELS}
    row = {"phase": "mesh_summary", "nvidia_smi": smi,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": torch.distributed.get_backend()}
    for mode in ("paged", "tree"):
        res, _, l_m, info = run_mode(
            torch, np, mode, models, prompts, recorder, phase="mesh",
            ecfg_over=dict(mesh=mesh), info_over={"nvidia_smi": smi},
            dev=dev)
        same, worst = same_trees(main_res[mode], res)
        row[mode] = {"same_tree_as_main": same, "max_reward_rel_gap": worst,
                     "shard_fallbacks": info["shard_fallbacks"]}
        if not same or worst > TOL_FAMILY_REWARD:
            emit(row)
            fail(f"mesh {mode}: the trees differ from the main phase's "
                 f"({same}, reward gap {worst})")
        want = "paged_attention" if mode == "paged" else "tree_attention"
        if not (l_m[want] and l_m["flash_prefill"]):
            fail(f"mesh {mode}: a kernel of the path did not launch: {l_m}")
        for k, v in l_m.items():
            launches[k] += v
    try:
        check_mesh_compat(TwoDeviceMesh(), use_kernel=True)
    except ValueError as e:
        row["two_device_mesh_refused"] = str(e)
    else:
        fail("check_mesh_compat let a 2-device mesh through to the kernels")
    row["launches"] = launches
    emit(row)
    check_recorded(recorder, "mesh")
    serve = phase_serve(torch, smi, dev, argv=["--mesh", "1"],
                        path="mesh:serve")
    return {"mesh": launches, "mesh:serve": serve}


def phase_dense_prefill(torch, np, models, prompts, main_res, smi,
                        dev="cuda"):
    """``EngineConfig(prefill="dense")``, the reference's one-shot oracle,
    against the flash kernel at llama3.2-1b width: the four prompts'
    prefill logits within ``TOL_DENSE_LOGITS``, the prefill ms of each
    (the second of two calls, CUDA events), then the main phase's greedy
    sweep with the dense prefill, whose trees must equal the main
    phase's in both modes."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, PagedEngine
    (lm, lp), _, _ = models
    fresh_peak(torch, dev)
    ops.reset_launch_counts()
    logits, ms = {}, {}
    for prefill in ("flash", "dense"):
        engine = PagedEngine(lm, lp, EngineConfig(
            n_pages=1024, page_size=16, max_batch=32, max_seq_len=512,
            prefill=prefill, trace_logits=True), device=dev)
        for sid in engine.prefill_many(prompts):      # warm-up
            engine.free(sid)
        _, ms[prefill] = event_ms(torch, dev,
                                  lambda: engine.prefill_many(prompts))
        logits[prefill] = torch.as_tensor(engine.logits_trace[-1])
        del engine
    launches = launch_counts(ops)
    gap = float((logits["flash"] - logits["dense"]).abs().max())
    row = {"phase": "dense_prefill", "nvidia_smi": smi,
           "prompt_tokens": [len(p) for p in prompts],
           "logits_max_abs_gap": gap, "tol": TOL_DENSE_LOGITS,
           "logits_max_abs": float(logits["dense"].abs().max()),
           "flash_prefill_ms": ms["flash"], "dense_prefill_ms": ms["dense"],
           "dense_over_flash": ms["dense"] / ms["flash"]}
    if not launches["flash_prefill"]:
        fail(f"dense_prefill: the flash engine launched no kernel: "
             f"{launches}")
    for mode in ("paged", "tree"):
        res, _, l_m, _ = run_mode(
            torch, np, mode, models, prompts, phase="dense_prefill",
            ecfg_over=dict(prefill="dense"), info_over={"nvidia_smi": smi},
            dev=dev)
        same, worst = same_trees(main_res[mode], res)
        row[mode] = {"same_tree_as_main": same, "max_reward_rel_gap": worst,
                     "launches": l_m}
        if l_m["flash_prefill"]:
            fail(f"dense_prefill {mode}: the dense oracle launched the "
                 f"flash kernel")
        for k, v in l_m.items():
            launches[k] += v
        if not same or worst > TOL_FAMILY_REWARD:
            emit(row)
            fail(f"dense_prefill {mode}: the trees differ from the flash "
                 f"engine's ({same}, reward gap {worst})")
    row["launches"] = launches
    emit(row)
    if gap > TOL_DENSE_LOGITS:
        fail(f"dense_prefill: logits {gap} apart (tolerance "
             f"{TOL_DENSE_LOGITS})")
    return launches


def ep_capacity(cfg):
    """The config at ``EP_CAPACITY_FACTOR``."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CAPACITY_FACTOR))


def phase_expert_parallel(torch, np, smi, dev="cuda", shrink=None):
    """deepseek-moe-16b at full width, 4 of 28 layers, capacity factor
    ``EP_CAPACITY_FACTOR``, with the expert-parallel MoE on a (1,1) mesh
    of a world-size-1 NCCL group: one layer's
    ``moe_apply_expert_parallel`` against ``moe_apply`` on the same
    tokens (``TOL_EP``; no replica dropped), then the families phase's
    greedy sweep in paged and tree mode with expert parallelism off and
    on, whose trees must be equal, every kernel launching; the
    all_to_all calls counted.  Returns the path's launches (the EP-on sweeps')."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import layer_slice
    base = fresh_peak(torch, dev)
    cut = (lambda c: ep_capacity(shrink(c))) if shrink else ep_capacity
    models = family_models(torch, "deepseek-moe-16b", 4, 2, dev, cut)
    (lm, lp), _, _ = models
    cfg = lm.cfg
    mesh = make_host_mesh(device=dev)
    gi = next(i for i, g in enumerate(lp["groups"]) if "moe" in g)
    p = layer_slice(lp["groups"][gi], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((EP_TOKENS, cfg.d_model), generator=gen, device=dev)
    saved = (MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS)
    try:
        with torch.no_grad():
            y_ref, aux_ref = MOE.moe_apply(p, x, cfg)
            _, idx, _ = MOE.route(p["router"], x, cfg)
            C = MOE._capacity(cfg, EP_TOKENS * cfg.moe.top_k, 0)
            dropped = int((~MOE.dispatch_plan(idx, cfg.moe.n_experts,
                                              C)[3]).sum())
            MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = mesh, ("data",), 1
            n0 = MOE.N_ALL_TO_ALL
            y, aux = MOE.moe_apply_expert_parallel(p, x, cfg)
            layer_a2a = MOE.N_ALL_TO_ALL - n0
        err = float(((y - y_ref).abs() / (TOL_EP + TOL_EP * y_ref.abs()))
                    .max())
        row = {"phase": "expert_parallel", "nvidia_smi": smi,
               "arch": cfg.name, "n_layers": cfg.n_layers,
               "capacity_factor": cfg.moe.capacity_factor,
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "layer_tokens": EP_TOKENS, "layer_capacity": C,
               "layer_dropped_replicas": dropped,
               "layer_max_abs_err": float((y - y_ref).abs().max()),
               "layer_err_over_tol": err, "tol": TOL_EP,
               "aux_gap": float((aux - aux_ref).abs()),
               "layer_all_to_all": layer_a2a}
        if err > 1.0 or dropped:
            emit(row)
            fail(f"expert_parallel: one layer {row['layer_max_abs_err']} "
                 f"from moe_apply, {dropped} replicas dropped")
        rng = np.random.default_rng(0)
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
                   for n in rng.integers(128, 257, 4)]
        runs, launches = {}, {k.name: 0 for k in ops.KERNELS}
        for ep in (False, True):
            MOE.MESH = mesh if ep else None
            n0 = MOE.N_ALL_TO_ALL
            for mode in ("paged", "tree"):
                res, _, l_m, _ = run_mode(
                    torch, np, mode, models, prompts,
                    phase="expert_parallel",
                    ecfg_over=dict(n_state_pages=FAMILY_STATE_PAGES),
                    bcfg_over=dict(step_token=FAMILY_STEP_TOKEN,
                                   eos_token=FAMILY_EOS_TOKEN),
                    info_over={"nvidia_smi": smi, "expert_parallel": ep},
                    dev=dev)
                runs[ep, mode] = res
                if ep:
                    for k, v in l_m.items():
                        launches[k] += v
            row["sweep_all_to_all" if ep else "sweep_all_to_all_off"] = \
                MOE.N_ALL_TO_ALL - n0
    finally:
        MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = saved
    for mode in ("paged", "tree"):
        same, worst = same_trees(runs[False, mode], runs[True, mode])
        row[mode] = {"same_tree_as_ep_off": same,
                     "max_reward_rel_gap": worst}
        if not same or worst > TOL_FAMILY_REWARD:
            emit(row)
            fail(f"expert_parallel {mode}: the trees differ from the EP-off "
                 f"sweep's ({same}, reward gap {worst})")
    row.update(launches=launches,
               peak_over_phase_base_bytes=peak_bytes(torch, dev) - base)
    emit(row)
    if not row["sweep_all_to_all"] or row["sweep_all_to_all_off"]:
        fail(f"expert_parallel: all_to_all calls {row['sweep_all_to_all']} "
             f"with EP on, {row['sweep_all_to_all_off']} off")
    if not all(n for k, n in launches.items() if k != SAMPLER):
        fail(f"expert_parallel: a kernel of the path did not launch: "
             f"{launches}")
    del models, lm, lp, p, x, y, y_ref, runs
    fresh_peak(torch, dev)
    return launches


def start_dryrun(out_dir, combos=DRYRUN_COMBOS):
    """One ``python -m repro_torch.launch.dryrun`` process per combo
    (each owns its fake process group), at the lowest CPU priority and
    with no GPU visible; returns the processes."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mp, opt in combos:
        cmd = ["nice", "-n", "19", sys.executable, "-m",
               "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--out", str(out_dir)] + (["--multi-pod"] if mp else []) \
            + (["--opt"] if opt else [])
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def phase_dryrun(torch, smi, procs, out_dir, t_started):
    """Collect the dry-run processes (started earlier, ``start_dryrun``):
    every record must be ``ok`` or the policy's skip.  Prints one line
    per record (per-device peak GB, the roofline terms) and the report's
    tables (``repro_torch.analysis.report``).  No kernel runs and the
    card's memory does not move."""
    import os
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    mem0 = torch.cuda.memory_allocated()
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=DRYRUN_TIMEOUT)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    bad = [(pr.returncode, out[-1500:]) for pr, out in zip(procs, outs)
           if pr.returncode != 0]
    recs = [json.loads(Path(out_dir, f).read_text())
            for f in sorted(os.listdir(out_dir)) if f.endswith(".json")]
    for r in recs:
        row = {"phase": "dryrun", "nvidia_smi": smi, "arch": r["arch"],
               "shape": r["shape"], "mesh": r["mesh"], "status": r["status"],
               "variant": r.get("variant")}
        if r["status"] == "ok":
            rf, m = r["roofline"], r["memory"]
            row.update(chips=rf["chips"],
                       peak_gb_per_device=m["peak_bytes_est"] / 1e9,
                       argument_gb=m["argument_bytes"] / 1e9,
                       compute_s=rf["compute_s"], memory_s=rf["memory_s"],
                       collective_s=rf["collective_s"],
                       bottleneck=rf["bottleneck"],
                       flops_per_device=rf["flops"],
                       dot_bytes_per_device=rf["bytes_hbm"],
                       collective_bytes_per_device=rf["bytes_collective"],
                       useful_flops_ratio=rf["useful_flops_ratio"],
                       n_collectives=r.get("n_collectives"),
                       trace_s=r["lower_s"])
        else:
            row.update(reason=r.get("reason"), error=r.get("error"),
                       operator=r.get("operator"))
        emit(row)
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report", "--dir",
         str(out_dir)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC),
                                           CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    emit({"phase": "dryrun_report", "returncode": report.returncode,
          "tables": report.stdout})
    launches = launch_counts(ops)
    emit({"phase": "dryrun_summary", "records": len(recs),
          "ok": sum(r["status"] == "ok" for r in recs),
          "skip": sum(r["status"] == "skip" for r in recs),
          "wall_s_since_start": time.perf_counter() - t_started,
          "card_memory_moved_bytes": torch.cuda.memory_allocated() - mem0,
          "launches": launches})
    if bad:
        fail(f"dryrun: {len(bad)} processes failed: {bad[:2]}")
    if len(recs) != len(DRYRUN_COMBOS) or report.returncode != 0:
        fail(f"dryrun: {len(recs)} records of {len(DRYRUN_COMBOS)}, "
             f"report rc {report.returncode}: {report.stderr[-500:]}")
    for r in recs:
        skip_ok = r["status"] == "skip" and (r["arch"], r["shape"]) \
            in DRYRUN_POLICY_SKIPS
        if r["status"] != "ok" and not skip_ok:
            fail(f"dryrun: {r['arch']} {r['shape']} {r['mesh']}: "
                 f"{r['status']} {r.get('error', r.get('reason'))}")
    if any(launches.values()) or torch.cuda.memory_allocated() != mem0:
        fail(f"dryrun: the card was used: {launches}")
    return launches


def run_phase(name, fn, *args, **kw):
    """``fn(*args, **kw)``, then one line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "seconds", "of": name,
          "seconds": round(time.perf_counter() - t0, 3)})
    return out


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
    t_start = time.perf_counter()
    smi = phase_device(torch)
    run_phase("build", phase_build)
    run_phase("parity", phase_parity, torch, np)
    timer = Timer(torch)
    recorder, by_path, models, prompts, main_res = run_phase(
        "main", phase_main, torch, np, timer)
    by_path.update(run_phase("mesh", phase_mesh, torch, np, models, prompts,
                             main_res, smi))
    by_path["dense_prefill"] = run_phase("dense_prefill", phase_dense_prefill,
                                         torch, np, models, prompts,
                                         main_res, smi)
    del main_res
    rng = np.random.default_rng(1)
    long_prompt = list(map(int, rng.integers(0, 128000, LONG_PROMPT)))
    swap_prompt = list(map(int, rng.integers(0, 128000, 256)))
    by_path["streamed"] = run_phase("streamed", phase_streamed, torch,
                                    models, long_prompt, smi)
    by_path["swap"] = run_phase("swap", phase_swap, torch, models,
                                swap_prompt, smi)
    by_path["serving"], costs = run_phase("serving", phase_serving, torch,
                                          models, long_prompt, smi)
    by_path.update(run_phase("replicas", phase_replicas, torch, np, models,
                             long_prompt, costs, smi))
    # the full-width models of the phases above are not needed again
    del models, prompts
    by_path["train"] = run_phase("train", phase_train, torch, np, smi)
    by_path["example"] = run_phase("example", phase_example, torch, smi)
    by_path["serve"] = run_phase("serve", phase_serve, torch, smi)
    by_path["replicas:serve"] = run_phase(
        "replicas:serve", phase_serve, torch, smi,
        argv=["--replicas", str(REPLICAS)], path="replicas:serve")
    by_path.update(run_phase("families", phase_families, torch, np, smi,
                             timer=timer))
    by_path["vlm"], _ = run_phase("vlm", family_run, torch, np,
                                  "qwen2-vl-7b", None, 6, None, smi, "cuda",
                                  timer=timer, path="vlm")
    by_path["vlm:forward"] = run_phase("vlm_frontend", phase_vlm_frontend,
                                       torch, np, smi)
    by_path["hubert"] = run_phase("hubert", phase_hubert, torch, np, smi)
    by_path["expert_parallel"] = run_phase(
        "expert_parallel", phase_expert_parallel, torch, np, smi)
    # the dry run is CPU work on a fake process group: it runs beside the
    # last, device-bound phases and is collected after them
    dry_dir = tempfile.TemporaryDirectory()
    t_dry = time.perf_counter()
    dry_procs = start_dryrun(dry_dir.name)
    by_path["train_families"] = run_phase("train_families",
                                          phase_train_families, torch, np,
                                          smi)
    by_path["contiguous"] = run_phase("contiguous", phase_contiguous, torch,
                                      np, smi)
    by_path["steps"] = run_phase("steps", phase_steps, torch, np, smi)
    by_path["dryrun"] = run_phase("dryrun", phase_dryrun, torch, smi,
                                  dry_procs, dry_dir.name, t_dry)
    dry_dir.cleanup()
    from repro_torch.kernels import ops
    launches = {k.name: sum(p[k.name] for p in by_path.values())
                for k in ops.KERNELS}
    lines = run_phase("replay", phase_replay, torch, recorder, launches,
                      timer)
    for line in lines:
        line["launches_by_path"] = {p: n[line["name"]]
                                    for p, n in by_path.items()}
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    emit({"phase": "seconds", "of": "smoke",
          "seconds": round(time.perf_counter() - t_start, 3)})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
