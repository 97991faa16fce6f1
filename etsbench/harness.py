"""One run of one cell: set up, ramp, measure, judge, report.

The cell names a configuration (``configs/<name>.json``: the published
config, the sizes the port runs, the PRM, the embedder, the serving
tokens) and a traffic mix (``traffic/<name>.json``).  The harness

  1. makes every model's weights on the card from the seed, in the
     served dtype, and builds the port's paged engine in tree mode, its
     search backend and its serving loop (``ServingLoop``, token-level
     refill), over a backlog of problems from the mix, all at time 0;
  2. ticks the loop until the first admitted problem retires (the ramp:
     the first wave prefills, decodes and scores every shape the window
     will use), which opens the window; everything before is set-up;
  3. ticks the loop for ``--seconds`` and closes the window;
  4. reads the end-to-end metrics from its own stamps, frees the
     server, and judges what the window served against the plain
     reference (``check.py``);
  5. with ``--trace 1``, times the layers with spans around the calls
     into them (synchronised), profiles the card over the whole window,
     and reports the per-layer metrics that ``metrics/<name>.py`` read.

The program is ``repro_torch``; the harness wraps its calls (never
edits it) and takes from it only the system under test.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, traffic, weights
from .roofline import work

BANNED = ("jax", "jaxlib", "flax", "repro")
SPANS = ("prefill", "decode", "prm", "embed", "select")
MIB = float(2 ** 20)


class Fail(Exception):
    """A run that must print no result."""


def parse(argv):
    ap = argparse.ArgumentParser(prog="etsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# the files a cell is made of
# ---------------------------------------------------------------------------

class Cell:
    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise Fail(f"no workload {name!r} in BENCHMARK.json")
        self.w = cells[name]
        self.name = name
        base = root / bench["paths"][0]
        cfg = next(c for c in bench["configs"] if c["name"] == self.w["config"])
        self.config = json.loads((root / cfg["file"]).read_text())
        self.mix = json.loads((base / "traffic" /
                               f"{self.w['traffic']}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{name}.json"
                                  ).read_text())["limits"]
        self.chips = int(self.w["chips"])
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.readers = {m["name"]: _reader(base / "metrics" /
                                           f"{m['name']}.py")
                        for m in self.per_layer}


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "etsbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the probes: the harness's stamps, spans and captures around the program
# ---------------------------------------------------------------------------

class Probe:
    def __init__(self, torch, backend, engine, traced: bool,
                 page_bytes: int):
        self.torch = torch
        self.backend = backend
        self.engine = engine
        self.traced = traced
        self.cuda = engine.device.type == "cuda"
        self.page_bytes = page_bytes
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.last_done: Dict = {}        # ns -> stamp of last completed step
        self.step_start: Dict = {}       # ns -> stamp the step began
        self.prompt_len: Dict = {}       # ns -> prompt tokens
        self.steps_done: Dict = {}       # ns -> steps closed so far
        self.stepped: set = set()        # ns that closed a step in window
        self.gaps: List[float] = []
        self.kv_by_ns: Dict = {}         # ns -> [(step, pages)] in window
        self.attempted = 0
        self.spans = {k: [0.0, 0] for k in SPANS}
        self.prm_slots = self.prm_valid = 0
        self.in_prm = False
        self.ets_calls: Dict = {}
        self.score_calls: List[List[tuple]] = []
        self.profiling = False
        self.span_ns: List[tuple] = []   # (start, end, layer), profiled
        self.tree_bound = [0.0, 0]       # least seconds, calls
        self.flash_bound = [0.0, 0]
        self.flops = 0.0                 # useful FLOPs in the window
        self._prefill_lens: Optional[List[int]] = None
        self._undo: List = []

    # -- time ---------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def in_window(self, t: float) -> bool:
        return self.t_open is not None and t >= self.t_open and (
            self.t_close is None or t <= self.t_close)

    # -- wrapping -----------------------------------------------------
    def _set(self, obj, name, fn):
        had = name in vars(obj)
        self._undo.append((obj, name, vars(obj)[name] if had else _MISSING))
        setattr(obj, name, fn)

    def restore(self) -> None:
        """Undo every wrapper (module attributes above all: the tests run
        several cells in one process)."""
        for obj, name, old in reversed(self._undo):
            if old is _MISSING:
                vars(obj).pop(name, None)
            else:
                setattr(obj, name, old)
        self._undo.clear()

    def _span(self, name: str, fn):
        def wrapped(*a, **k):
            if not self.traced:
                return fn(*a, **k)
            n0 = time.time_ns()
            t0 = self.now()
            out = fn(*a, **k)
            self.sync()
            t1 = self.now()
            if self.in_window(t0):
                s = self.spans[name]
                s[0] += t1 - t0
                s[1] += 1
                if self.profiling:
                    self.span_ns.append((n0, time.time_ns(), name))
            return out
        return wrapped

    def install(self, loop, flops) -> None:
        import repro_torch.core.controllers as controllers
        import repro_torch.serving.search_backend as sb
        from repro_torch.kernels import ops
        be, eng = self.backend, self.engine
        traced = self.traced

        start_many = be.start_many

        def _start_many(prompts):
            trees = start_many(prompts)
            t = self.now()
            for p, tr in zip(prompts, trees):
                ns = tr.node(0).payload["ns"]
                self.last_done[ns] = t
                self.prompt_len[ns] = len(p)
                if traced and self.in_window(t):
                    self.flops += flops["prefill"](len(p))
            return trees
        self._set(be, "start_many", self._span("prefill", _start_many))

        expand_begin = be.expand_begin

        def _expand_begin(tree, lc):
            t = self.now()
            ticket = expand_begin(tree, lc)
            if ticket.branches:
                self.step_start[tree.node(0).payload["ns"]] = t
            return ticket
        self._set(be, "expand_begin", _expand_begin)

        on_step = be.on_step

        def _on_step(tree, live):
            on_step(tree, live)
            t = self.now()
            ns = tree.node(0).payload["ns"]
            self.steps_done[ns] = self.steps_done.get(ns, 0) + 1
            if self.in_window(t):
                self.stepped.add(ns)
                self.gaps.append(t - self.last_done[ns])
                if self.step_start.get(ns, -math.inf) >= self.t_open:
                    self.attempted += 1
                if live:
                    # the allocator's count after this step's pruning:
                    # pages on the card plus any spilled to the host
                    held = be.problem_pages(tree) \
                        + be.problem_swapped_pages(tree)
                    self.kv_by_ns.setdefault(ns, []).append(
                        (self.steps_done[ns], held))
            self.last_done[ns] = t
        self._set(be, "on_step", _on_step)

        score_multi = be.score_multi

        def _score_multi(reqs):
            call = [(tr.node(0).payload["ns"], int(n))
                    for tr, nodes in reqs for n in nodes]
            self.score_calls.append(call)
            self.in_prm = True
            try:
                out = score_multi(reqs)
            finally:
                self.in_prm = False
            if traced and self.in_window(self.now()):
                for tr, nodes in reqs:
                    for n in nodes:
                        self.flops += flops["prm"](
                            self.prompt_len[tr.node(0).payload["ns"]]
                            + _path_len(tr, n))
            return out
        self._set(be, "score_multi", self._span("prm", _score_multi))

        embed_multi = be.embed_multi

        def _embed_multi(reqs):
            out = embed_multi(reqs)
            if traced and self.in_window(self.now()):
                for tr, nodes in reqs:
                    for n in nodes:
                        self.flops += flops["embedder"](
                            len(tr.node(n).payload["tokens"]))
            return out
        self._set(be, "embed_multi", self._span("embed", _embed_multi))

        open_stream = be.open_stream

        def _open_stream():
            stream = open_stream()
            stream.step = self._span("decode", stream.step)
            return stream
        self._set(be, "open_stream", _open_stream)

        pad = sb._pad_bucket

        def _pad_bucket(seqs):
            out = pad(seqs)
            if traced and self.in_prm and self.in_window(self.now()):
                self.prm_slots += out[0].size
                self.prm_valid += sum(len(s) for s in seqs)
            return out
        self._set(sb, "_pad_bucket", _pad_bucket)

        prune = controllers.ets_prune

        def _ets_prune(tree, candidates, rewards, n_total, cfg,
                       embeddings=None):
            step = prune(tree, candidates, rewards, n_total, cfg, embeddings)
            self.ets_calls.setdefault(tree.node(0).payload["ns"], []).append({
                "candidates": [int(c) for c in candidates],
                "rewards": [float(r) for r in rewards],
                "embs": None if embeddings is None
                else np.asarray(embeddings).copy(),
                "n_total": int(n_total),
                "selected": [int(i) for i in step.selected],
                "counts": [int(c) for c in step.counts]})
            return step
        self._set(controllers, "ets_prune", self._span("select", _ets_prune))

        if not traced:
            return
        meta_fn = eng.alloc.tree_metadata
        cfg = eng.cfg
        el = eng.pool.k.element_size()
        n_layers = eng.n_kv_layers
        pool_dt = "float32" if el == 4 else "bfloat16"

        def _tree_metadata(rows, **kw):
            meta = meta_fn(rows, **kw)
            if self.in_window(self.now()):
                mask = meta.page_mask[:meta.n_unique]
                lens = meta.page_lens[:meta.n_unique]
                ctx = int((mask.astype(np.int64).sum(axis=1) * lens).sum())
                self.flops += flops["decode_attn"](ctx)
                if self.profiling:
                    nb, fl = work.tree_call(meta.page_mask, meta.page_lens,
                                            meta.n_unique, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.head_dim, el)
                    self.tree_bound[0] += n_layers * work.bound_s(nb, fl,
                                                                  pool_dt)
                    self.tree_bound[1] += n_layers
            return meta
        self._set(eng.alloc, "tree_metadata", _tree_metadata)

        chunk = eng._prefill_chunk

        def _prefill_chunk(handles, ctxs):
            self._prefill_lens = [len(c) for c in ctxs]
            try:
                return chunk(handles, ctxs)
            finally:
                self._prefill_lens = None
        self._set(eng, "_prefill_chunk", _prefill_chunk)

        flash = ops.flash_prefill

        def _flash(q, k, v, **kw):
            if self.profiling and self._prefill_lens is not None:
                nb, fl = work.flash_call(self._prefill_lens, q.shape[2],
                                         k.shape[2], q.shape[3],
                                         q.element_size())
                dt = "bfloat16" if q.dtype == self.torch.bfloat16 \
                    else "float32"
                self.flash_bound[0] += work.bound_s(nb, fl, dt)
                self.flash_bound[1] += 1
            return flash(q, k, v, **kw)
        self._set(ops, "flash_prefill", _flash)


_MISSING = object()


def _path_len(tree, n) -> int:
    t = 0
    while n != 0:
        t += tree.node(n).n_tokens
        n = tree.node(n).parent
    return t


# ---------------------------------------------------------------------------
# useful FLOPs per token of each model (model.mfu)
# ---------------------------------------------------------------------------

def _flop_rates(lm, prm, emb) -> Dict:
    def dense_per_token(s, head):
        d, L = s["d_model"], s["n_layers"]
        H, K, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
        p = d * hd * (2 * H + 2 * K)
        if s.get("moe"):
            m = s["moe"]
            p += 3 * d * m["d_expert"] * (m["top_k"] + m["n_shared_experts"])
            p += d * m["n_experts"]
        else:
            p += (3 if s["act"] == "swiglu" else 2) * d * s["d_ff"]
        return 2 * (L * p + head)

    def attn(s):      # FLOPs of one token attending n tokens, all layers
        return 4 * s["n_layers"] * s["n_heads"] * s["head_dim"]

    lm_tok = dense_per_token(lm, lm["d_model"] * lm["vocab_size"])
    prm_tok = dense_per_token(prm, prm["d_model"])
    emb_tok = dense_per_token(emb, 0)

    def causal(s, per_tok):
        return lambda n: n * per_tok + attn(s) * n * (n + 1) / 2

    return {"prefill": causal(lm, lm_tok), "prm": causal(prm, prm_tok),
            "embedder": lambda n: n * emb_tok + attn(emb) * n * n,
            "decode_token": lm_tok,
            "decode_attn": lambda ctx: attn(lm) * ctx}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _model_config(mc, moe_cls, spec: Dict, name: str):
    kw = {k: v for k, v in spec.items()
          if k in {f.name for f in dataclasses.fields(mc)}}
    if spec.get("moe"):
        kw["moe"] = moe_cls(**{k: v for k, v in spec["moe"].items()
                               if k in {f.name for f in
                                        dataclasses.fields(moe_cls)}})
    kw["name"] = name
    if "mrope_sections" in kw:
        kw["mrope_sections"] = tuple(kw["mrope_sections"])
    return mc(**kw)


def run(argv, *, root: Path, t_start: float, device: Optional[str] = None,
        faults=None, control: Optional[Dict] = None,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> Dict:
    """One run; returns the result line's object (with ``checks`` last).
    ``device`` (the benchmark's own tests only) skips the look for a card
    and runs there; ``faults`` (tests only) breaks the timed path after
    set-up; ``control`` (the control script) adds the control's readings
    to each check."""
    args = parse(argv)
    cell = Cell(root, args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            raise Fail(f"{cell.name} needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    try:
        from repro_torch.configs.base import ModelConfig, MoEConfig
        from repro_torch.core import ETSConfig, SearchConfig
        from repro_torch.core.serving import (Request, ServingConfig,
                                              ServingLoop)
        from repro_torch.models.model import LM
        from repro_torch.serving import EngineConfig, PagedEngine
        from repro_torch.serving.search_backend import (BackendConfig,
                                                        LMBackend)
    except ImportError as e:
        raise Fail(f"the program under test is missing: {e}")

    port = cell.config["port"]
    specs = {k: weights.spec_of(port[k]) for k in ("lm", "prm", "embedder")}
    mix = cell.mix
    seed = int(args.seed)
    key_seed = seed & 0xFFFFFFFF
    # -- the models, their weights from the seed ------------------------
    heads = {"lm": "lm", "prm": "value", "embedder": "none"}
    models, params = {}, {}
    for i, k in enumerate(("lm", "prm", "embedder")):
        mcfg = _model_config(ModelConfig, MoEConfig, specs[k],
                             f"{cell.w['config']}.{k}")
        models[k] = LM(mcfg, with_value_head=k == "prm", device=dev)
        params[k] = weights.make(specs[k], heads[k], seed * 4 + i, dev)
    serving = cell.config["serving"]
    width, steps = int(mix["width"]), int(mix["max_steps"])
    step_tokens, ps = int(mix["max_step_tokens"]), int(mix["page_size"])
    max_len = traffic.max_prompt(mix) + (steps + 1) * step_tokens + ps
    ecfg = EngineConfig(n_pages=int(mix["pool_pages"]), page_size=ps,
                        max_batch=int(mix["max_live"]) * width,
                        max_seq_len=-(-max_len // ps) * ps,
                        attention="tree")
    engine = PagedEngine(models["lm"], params["lm"], ecfg, device=dev)
    bcfg = BackendConfig(step_token=int(serving["step_token"]),
                         eos_token=int(serving["eos_token"]),
                         max_step_tokens=step_tokens, max_depth=steps + 1,
                         temperature=float(mix["temperature"]))
    backend = LMBackend(engine, models["prm"], params["prm"],
                        models["embedder"], params["embedder"], bcfg,
                        answer_fn=lambda toks: None, seed=key_seed,
                        device=dev)
    ets_cfg = dict(mix["ets"])
    scfg = SearchConfig(method=mix["method"], width=width, max_steps=steps,
                        ets=ETSConfig(**ets_cfg))
    prompts = traffic.prompts(mix, specs["lm"]["vocab_size"], seed)
    loop = ServingLoop(backend, scfg, [Request(prompt=p) for p in prompts],
                       max_live=int(mix["max_live"]),
                       cfg=ServingConfig(refill=True))
    pool = engine.pool
    page_bytes = (pool.k[:, 0].numel() + pool.v[:, 0].numel()) \
        * pool.k.element_size()
    traced = bool(args.trace)
    probe = Probe(torch, backend, engine, traced, page_bytes)
    rates = _flop_rates(specs["lm"], specs["prm"], specs["embedder"])
    probe.install(loop, rates)
    try:
        return _measure(torch, args, cell, probe, loop, engine, backend,
                        prompts, params, specs, ets_cfg, seed, key_seed,
                        t_start, dev, faults, control, rates, log)
    finally:
        probe.restore()


def _measure(torch, args, cell, probe, loop, engine, backend, prompts,
             params, specs, ets_cfg, seed, key_seed, t_start, dev, faults,
             control, rates, log) -> Dict:
    cuda = dev.type == "cuda"
    # -- the ramp: until the first admitted problem retires -------------
    while not loop.results:
        if not loop.tick():
            raise Fail("the backlog drained before the window opened")
    if faults:
        faults(engine, backend)
    tracer = None
    if probe.traced and cuda:
        from .devtrace import DeviceTrace
        tracer = DeviceTrace(torch)
        tracer.start()
    probe.sync()
    t_open = probe.now()
    probe.t_open = t_open
    c0 = _counters(engine)
    if tracer is not None:
        tracer.open()
        probe.profiling = True
    while True:
        t = probe.now()
        if t - t_open >= args.seconds:
            break
        if not loop.tick():
            raise Fail("the backlog drained inside the window: make it "
                       "longer")
    probe.sync()
    t_close = probe.now()
    probe.t_close = t_close
    if tracer is not None and probe.profiling:
        tracer.stop()
        probe.profiling = False
    c1 = _counters(engine)
    window_s = t_close - t_open
    swaps = c1["swap_outs"] - c0["swap_outs"]
    kv_pages = [p for v in probe.kv_by_ns.values() for _, p in v]
    log(f"window {window_s:.3f} s: {c1['decoded'] - c0['decoded']} tokens, "
        f"{len(probe.gaps)} step gaps, {len(kv_pages)} KV samples, "
        f"{swaps} swap-outs, {loop.stats.deferred_admissions} deferred "
        f"admissions")
    log("KV samples by step: " + json.dumps(_kv_by_step(probe.kv_by_ns)))
    if not probe.gaps or not kv_pages:
        raise Fail("the window completed no search step: make it longer")
    e2e = {
        "search_tok_s": (c1["decoded"] - c0["decoded"]) / window_s,
        "step_gap_p90_s": float(np.percentile(probe.gaps, 90)),
        "kv_mib_per_problem": float(np.mean(kv_pages))
        * probe.page_bytes / MIB,
        "setup_s": t_open - t_start,
    }
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": probe.attempted, "failed": 0}
    trace = None
    if probe.traced:
        t_sum = probe.now()
        trace = tracer.summarize(probe.span_ns) if tracer is not None \
            else None
        if trace is not None:
            log(f"trace: {trace['n_device_ops']} device operations "
                f"({trace['outside_window']} outside the window) reduced "
                f"in {probe.now() - t_sum:.1f} s")
        ctx = {"window_s": window_s, "spans": probe.spans,
               "counters": {k: c1[k] - c0[k] for k in c0},
               "prm_slots": probe.prm_slots, "prm_valid": probe.prm_valid,
               "trace": trace, "tree_bound_s": probe.tree_bound[0],
               "tree_calls": probe.tree_bound[1],
               "flash_bound_s": probe.flash_bound[0],
               "flash_calls": probe.flash_bound[1],
               "useful_flops": probe.flops + rates["decode_token"]
               * (c1["decoded"] - c0["decoded"]),
               "peaks": work.PEAKS}
        per_layer = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                per_layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = per_layer
        if trace is not None:
            device["busy_s"] = trace["busy_s"]
            device["window_s"] = trace["window_s"]
    else:
        result["metrics"] = {k: {"value": float(v), "unit": units[k]}
                             for k, v in e2e.items() if k in units}
    result["device"] = device
    if trace is not None:
        ops = sorted(trace["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                               "idle_gaps": [[f"idle in {n}", s]
                                             for n, s in gaps[:10]]}
    log("end-to-end: " + json.dumps(e2e))
    # -- free the server, then judge what it served ----------------------
    trees = dict((i, r.tree) for i, r in loop.results.items())
    for i, st in list(loop.live.items()) + list(loop.parked.items()):
        trees[i] = st.tree
    by_ns = {t.node(0).payload["ns"]: i for i, t in trees.items()}
    served = check.Served(prompts, trees,
                          [by_ns[ns] for ns in probe.stepped],
                          {by_ns[ns]: n for ns, n in probe.steps_done.items()
                           if ns in by_ns},
                          probe.ets_calls, probe.score_calls, key_seed,
                          float(cell.mix["temperature"]))
    loop.__dict__.clear()
    backend.__dict__.clear()
    engine.__dict__.clear()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = probe.now()
    models = {k: (params[k], specs[k]) for k in ("lm", "prm", "embedder")}
    checks, readings, info = check.judge(served, seed, models, ets_cfg,
                                         cell.limits, control)
    log(f"reference {probe.now() - t_ref:.1f} s: {json.dumps(info)}")
    log(f"readings: {json.dumps(readings)}")
    result["correct"] = all(v["value"] <= v["limit"]
                            for v in checks.values())
    result["checks"] = checks
    found = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if found:
        raise Fail(f"modules of another stack are loaded: {found}")
    return result


def _kv_by_step(kv_by_ns: Dict) -> Dict:
    """The window's KV samples, for reading where their spread comes
    from: per step of a problem, [samples, mean pages]; and each
    problem's mean pages over its samples."""
    by_step: Dict[int, List[int]] = {}
    for samples in kv_by_ns.values():
        for step, pages in samples:
            by_step.setdefault(step, []).append(pages)
    return {"steps": {k: [len(v), float(np.mean(v))]
                      for k, v in sorted(by_step.items())},
            "problems": [round(float(np.mean([p for _, p in v])), 2)
                         for v in kv_by_ns.values()]}


def _counters(engine) -> Dict[str, int]:
    return {"decoded": engine.n_decoded_tokens,
            "decode_steps": engine.n_decode_steps,
            "unique_pages": engine.unique_pages_streamed,
            "logical_pages": engine.logical_pages_streamed,
            "swap_outs": engine.n_swap_outs}


def main(argv=None, *, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path.cwd()
    try:
        result = run(sys.argv[1:] if argv is None else argv, root=root,
                     t_start=t_start)
    except Fail as e:
        print(f"etsbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
