"""Training launcher (port of ``repro.launch.train``, local mode).

Trains ``--arch`` of any family (or its reduced variant with ``--tiny``)
as a float32 model over the arithmetic task's vocabulary, without remat
(as the reference's launcher), on the CUDA device unless ``--device``
names another, and optionally writes a checkpoint:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
        --steps 100 --ckpt /tmp/lm.npz

``--dry-run`` runs the train step of ``--arch`` at ``train_4k`` on the
production mesh instead (``launch.dryrun.lower_combo``, equivalent to
the dry run's train_4k; ``--multi-pod`` for the (2,16,16) mesh):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --dry-run
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_config, tiny_variant
from ..models.model import build_model
from ..training import TrainConfig, checkpoint, train_lm
from ..training.task import VOCAB_SIZE, ArithmeticTask


def model_and_params(arch: str, *, tiny: bool = False, device=None,
                     seed: int = 0, with_value_head: bool = False):
    """The launcher's model: ``arch`` (reduced with ``tiny``), float32,
    vocabulary ``max(VOCAB_SIZE, 32)``, no remat, params from a generator
    seeded ``seed`` on the model's device."""
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_variant(cfg)
    cfg = dataclasses.replace(cfg, vocab_size=max(VOCAB_SIZE, 32),
                              dtype="float32")
    model = build_model(cfg, with_value_head=with_value_head, remat=False,
                        device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init(gen)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tiny", action="store_true",
                    help="train the reduced variant of --arch")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns ``(model, params, loss history)``, or the dry run's record
    with ``--dry-run``."""
    args = parse_args(argv)
    if args.dry_run:
        from .dryrun import lower_combo
        rec = lower_combo(args.arch, "train_4k", multi_pod=args.multi_pod)
        print(rec.get("status"), rec.get("memory", rec.get("error")))
        return rec
    model, params = model_and_params(args.arch, tiny=args.tiny,
                                     device=args.device)
    task = ArithmeticTask(n_ops=3, seq_len=64)
    params, hist = train_lm(model, params, task,
                            TrainConfig(steps=args.steps, batch=args.batch))
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print(f"saved {args.ckpt}")
    return model, params, hist


if __name__ == "__main__":
    main()
