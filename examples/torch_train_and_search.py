"""End to end on the PyTorch port: train a tiny LM + PRM +
embedder on chained mod-10 arithmetic, then run PRM-guided tree search
(REBASE vs ETS) through the port's serving stack — paged KV pool,
block-table branching, CoW, lock-step batched decode with the CUDA
kernels — and report accuracy plus *measured* physical-page KV
occupancy.  The port of ``examples/train_and_search.py``.

    PYTHONPATH=src python examples/torch_train_and_search.py \
        [--train-steps 400] [--problems 10] [--width 12] [--device cuda]

Training and search run on the CUDA device unless ``--device`` names
another (``--device cpu`` takes the kernels' plain versions).
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ETSConfig, SearchConfig, run_search  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (BackendConfig, EngineConfig,  # noqa: E402
                                 LMBackend, PagedEngine)
from repro_torch.training import TrainConfig, train_lm, train_prm  # noqa: E402
from repro_torch.training.task import (ArithmeticTask, EOS,  # noqa: E402
                                       NEWLINE, VOCAB_SIZE, encode)


def build_models(train_steps: int, batch: int, *, device=None,
                 seed: int = 0):
    """Returns ``(task, lm_pack, prm_pack, emb_pack, train_info)``; the
    packs are ``(model, params)``, ``train_info`` holds both loss
    histories and the training seconds.  Params start from generators
    seeded ``seed``, ``seed + 1`` and ``seed + 2`` on ``device``."""
    dev = resolve_device(device)

    def init(model, i):
        return model.init(torch.Generator(device=dev).manual_seed(seed + i))

    t0 = time.perf_counter()
    task = ArithmeticTask(n_ops=3, seq_len=64)
    lm_cfg = dataclasses.replace(
        get_config("tiny-lm"), vocab_size=VOCAB_SIZE)
    lm = build_model(lm_cfg, device=dev)
    lm_params = init(lm, 0)
    lm_params, lm_hist = train_lm(lm, lm_params, task,
                                  TrainConfig(steps=train_steps, batch=batch))

    prm_cfg = dataclasses.replace(
        get_config("tiny-lm"), vocab_size=VOCAB_SIZE, n_layers=2)
    prm = build_model(prm_cfg, with_value_head=True, device=dev)
    prm_params = init(prm, 1)
    prm_params, prm_hist = train_prm(prm, prm_params, task,
                                     TrainConfig(steps=train_steps,
                                                 batch=batch))

    emb_cfg = dataclasses.replace(
        get_config("tiny-embedder"), vocab_size=VOCAB_SIZE)
    emb = build_model(emb_cfg, device=dev)
    emb_params = init(emb, 2)  # random features suffice
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    info = {"lm_history": lm_hist, "prm_history": prm_hist,
            "train_s": time.perf_counter() - t0}
    return task, (lm, lm_params), (prm, prm_params), (emb, emb_params), info


class CensusBackend(LMBackend):
    """``LMBackend`` that takes its problem's page census (physical and
    logical pages) after each closed search step."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.census = []

    def on_step(self, tree, live):
        super().on_step(tree, live)
        self.census.append(self.engine.alloc.ns_page_stats(
            tree.node(0).payload["ns"]))


def search_problems(task, lm_pack, prm_pack, emb_pack, *, method: str,
                    width: int, n_problems: int, lambda_b: float = 2.0):
    lm, lm_params = lm_pack
    dev = lm_params["embed"].device
    rng = np.random.default_rng(99)
    correct = 0
    phys_pages, logi_pages = [], []
    t0 = time.time()
    for i in range(n_problems):
        prompt, steps, ans = task.sample_problem(rng)
        engine = PagedEngine(lm, lm_params, EngineConfig(
            n_pages=2048, page_size=8, max_batch=max(width * 2, 32),
            max_seq_len=200), device=dev)
        backend = CensusBackend(
            engine, prm_pack[0], prm_pack[1], emb_pack[0], emb_pack[1],
            BackendConfig(step_token=NEWLINE, eos_token=EOS,
                          max_step_tokens=12, max_depth=8),
            answer_fn=ArithmeticTask.extract_answer, seed=1000 + i,
            device=dev)
        tree = backend.start(encode(prompt))
        scfg = SearchConfig(method=method, width=width, max_steps=8,
                            ets=ETSConfig(lambda_b=lambda_b, lambda_d=1.0,
                                          cluster_threshold=0.15))
        res = run_search(backend, scfg, tree=tree)
        correct += int(res.answer == ans)
        if backend.census:
            phys_pages.append(np.mean(
                [t["physical_pages"] for t in backend.census]))
            logi_pages.append(np.mean(
                [t["logical_pages"] for t in backend.census]))
    return {
        "method": method,
        "accuracy": correct / n_problems,
        "n_correct": correct,
        "avg_physical_pages": float(np.mean(phys_pages or [0])),
        "avg_logical_pages": float(np.mean(logi_pages or [0])),
        "wall_s": time.time() - t0,
    }


def main(argv=None):
    """Prints the table; returns ``(rows, train_info)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--problems", type=int, default=10)
    ap.add_argument("--width", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params' generators (seed, +1, +2)")
    args = ap.parse_args(argv)

    print("=== training tiny LM + PRM on chained mod-10 arithmetic ===")
    task, lm_pack, prm_pack, emb_pack, info = build_models(
        args.train_steps, args.batch, device=args.device, seed=args.seed)

    print("\n=== PRM tree search through the paged serving engine ===")
    print(f"{'method':8s} {'acc':>5s} {'phys pages':>10s} "
          f"{'logical':>8s} {'sharing':>8s} {'wall':>7s}")
    rows = []
    for method in ["rebase", "ets"]:
        r = search_problems(task, lm_pack, prm_pack, emb_pack,
                            method=method, width=args.width,
                            n_problems=args.problems)
        share = r["avg_logical_pages"] / max(r["avg_physical_pages"], 1e-9)
        print(f"{r['method']:8s} {r['accuracy']:5.2f} "
              f"{r['avg_physical_pages']:10.1f} "
              f"{r['avg_logical_pages']:8.1f} {share:7.2f}x "
              f"{r['wall_s']:6.1f}s")
        rows.append(r)
    print("\nphysical pages = unique KV actually stored (tree sharing); "
          "ETS's pruning\nreduces it further at equal accuracy.")
    return rows, info


if __name__ == "__main__":
    main()
