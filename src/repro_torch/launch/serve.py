"""Serving launcher (port of ``repro.launch.serve``): train a tiny LM +
PRM on the arithmetic task, then serve a Poisson workload or a trace
file through ``ServingLoop`` in tree mode, or through
``ReplicaServingLoop`` on ``--replicas N`` engines, and print the SLO
report.

    # Poisson workload, token-level refill, SLO report:
    PYTHONPATH=src python -m repro_torch.launch.serve --rate 0.05 \\
        --requests 12

    # replay a trace file (JSON list of {prompt, arrival, priority,
    # deadline}), lock-step baseline for comparison:
    PYTHONPATH=src python -m repro_torch.launch.serve --trace trace.json \\
        --no-refill

    # one arrival stream over 2 engine replicas, each KV pool placed on
    # a host mesh with a 1-wide model axis:
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \\
        --mesh 1

    # the serve step on the production mesh (fake process group):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --dry-run [--shape decode_32k] [--multi-pod]

The clock is virtual (stage costs, not wall time), so runs are
deterministic in ``--seed``.  Training and serving run on the CUDA
device unless ``--device`` names another.  The replicas share one set
of model weights; each has its own engine, KV pool, allocator and key
chains, seeded from the backend seed, so routing never changes an
answer.  ``--mesh MODEL`` places each engine on ``make_host_mesh``
(a world-size-1 group unless one exists, so MODEL is 1 on one device).
``--dry-run`` runs ``launch.dryrun.lower_combo`` for ``--arch`` at
``--shape`` and prints its status and memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..configs import get_config
from ..core import (ETSConfig, ReplicaServingLoop, SearchConfig,
                    ServingConfig, ServingLoop, load_trace,
                    poisson_requests)
from ..models.model import build_model
from ..serving import BackendConfig, EngineConfig, LMBackend, PagedEngine
from ..training import TrainConfig, train_lm, train_prm
from ..training.task import ArithmeticTask, EOS, NEWLINE, VOCAB_SIZE, encode


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--method", default="ets",
                    choices=["beam", "dvts", "rebase", "ets", "ets-kv"])
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8,
                    help="Poisson workload size (ignored with --trace)")
    ap.add_argument("--rate", type=float, default=0.05,
                    help="arrival rate, requests per virtual time unit")
    ap.add_argument("--trace", default=None,
                    help="JSON request trace to replay instead of Poisson")
    ap.add_argument("--priorities", type=int, nargs="*", default=None,
                    help="priority classes cycled over Poisson arrivals")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="per-request SLO: deadline = arrival + slack")
    ap.add_argument("--max-live", type=int, default=4,
                    help="per-replica live-problem bound")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas on the device, one arrival "
                         "stream")
    ap.add_argument("--mesh", type=int, default=0, metavar="MODEL",
                    help="place each engine's KV pool on a host mesh with "
                         "this model-axis size (0: no mesh)")
    ap.add_argument("--no-refill", action="store_true",
                    help="lock-step barrier baseline (refill off)")
    ap.add_argument("--first-finish", action="store_true",
                    help="halt each problem at its first completed answer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=250)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Prints the report; returns ``{"loop", "backends", "backend",
    "results", "answers", "report"}`` (``backend`` is the first
    replica's), or ``{"record"}`` with ``--dry-run``."""
    args = parse_args(argv)
    if args.dry_run:
        from .dryrun import lower_combo
        rec = lower_combo(args.arch, args.shape, multi_pod=args.multi_pod)
        print(rec.get("status"), rec.get("memory", rec.get("error")))
        return {"record": rec}

    task = ArithmeticTask(n_ops=4, seq_len=64)
    lm_cfg = dataclasses.replace(get_config(args.arch),
                                 vocab_size=VOCAB_SIZE)
    lm = build_model(lm_cfg, device=args.device)
    dev = lm.device

    def init(model, seed):
        return model.init(torch.Generator(device=dev).manual_seed(seed))

    lm_params, _ = train_lm(lm, init(lm, 0), task,
                            TrainConfig(steps=args.train_steps, batch=32,
                                        log_every=10 ** 9))
    prm = build_model(dataclasses.replace(lm_cfg, n_layers=2),
                      with_value_head=True, device=dev)
    prm_params, _ = train_prm(prm, init(prm, 1), task,
                              TrainConfig(steps=args.train_steps, batch=32,
                                          log_every=10 ** 9))
    emb_cfg = dataclasses.replace(get_config("tiny-embedder"),
                                  vocab_size=VOCAB_SIZE)
    emb = build_model(emb_cfg, device=dev)
    emb_params = init(emb, 2)

    mesh = None
    if args.mesh:
        from .mesh import make_host_mesh
        mesh = make_host_mesh(model=args.mesh, device=dev)
    ecfg = EngineConfig(
        n_pages=2048, page_size=8, max_batch=max(args.width * 2, 32),
        max_seq_len=200, attention="tree", mesh=mesh)

    def make_backend():
        # identically-seeded backends: a request's RNG namespace chain
        # is replica-invisible, so routing never changes an answer
        engine = PagedEngine(lm, lm_params, ecfg, device=dev)
        return LMBackend(engine, prm, prm_params, emb, emb_params,
                         BackendConfig(step_token=NEWLINE, eos_token=EOS,
                                       max_step_tokens=12, max_depth=8),
                         answer_fn=ArithmeticTask.extract_answer, seed=500,
                         device=dev)

    backends = [make_backend() for _ in range(max(args.replicas, 1))]
    scfg = SearchConfig(method=args.method, width=args.width, max_steps=8,
                        ets=ETSConfig(lambda_b=2.0, lambda_d=1.0,
                                      cluster_threshold=0.15))

    if args.trace:
        requests = load_trace(args.trace)
        answers = None
    else:
        rng = np.random.default_rng(args.seed)
        problems = [task.sample_problem(rng)
                    for _ in range(args.requests)]
        requests = poisson_requests(
            [encode(p) for p, _, _ in problems], rate=args.rate,
            seed=args.seed, priorities=args.priorities,
            deadline_slack=args.deadline_slack)
        answers = [a for _, _, a in problems]

    svc = ServingConfig(refill=not args.no_refill,
                        first_finish=args.first_finish)
    if len(backends) > 1:
        loop = ReplicaServingLoop(backends, scfg, requests,
                                  max_live=args.max_live, cfg=svc)
    else:
        loop = ServingLoop(backends[0], scfg, requests,
                           max_live=args.max_live, cfg=svc)
    results = loop.run()

    rep = loop.slo.report()
    mode = "lock-step" if args.no_refill else "refill"
    print(f"\n== online serving ({len(requests)} requests, {mode}"
          f"{', first-finish' if args.first_finish else ''}, "
          f"replicas={len(backends)}, max_live={args.max_live}) ==")
    for k in ("n_finished", "p50_tta", "p90_tta", "p99_tta", "mean_tta",
              "max_tta", "deadline_hit_rate"):
        v = rep.get(k)
        print(f"  {k:18s}: "
              + (f"{v:.2f}" if isinstance(v, float) else str(v)))
    if answers is not None:
        acc = sum(int(r.answer == a)
                  for r, a in zip(results, answers)) / len(answers)
        print(f"  {'accuracy':18s}: {acc:.2f}")
    print(json.dumps(rep))
    return {"loop": loop, "backends": backends, "backend": backends[0],
            "results": results, "answers": answers, "report": rep}


if __name__ == "__main__":
    main()
