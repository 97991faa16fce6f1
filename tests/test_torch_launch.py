"""The port's entry points on the CPU: ``repro_torch.launch.train`` and
``.serve``, the train-then-search example, what they leave out, the
search backend on params that require grad, and the slice as a whole —
train, then search — against the reference."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_stack import make_stacks
from repro import training as jtraining
from repro.core import ETSConfig as JaxETSConfig
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import run_search_many as jax_run_search_many
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend
from repro.training.task import ArithmeticTask as JArithmeticTask

from repro_torch.core import ETSConfig, SearchConfig, run_search_many
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)
from repro_torch.training import TrainConfig, checkpoint, train_lm, \
    train_prm
from repro_torch.training.task import EOS, NEWLINE, ArithmeticTask, encode

ROOT = Path(__file__).resolve().parents[1]


def test_train_launcher_writes_a_checkpoint_that_loads(tmp_path):
    path = str(tmp_path / "lm.npz")
    model, params, hist = launch_train.main(
        ["--arch", "tiny-lm", "--steps", "3", "--batch", "8", "--device",
         "cpu", "--ckpt", path])
    assert len(hist) == 2 and np.all(np.isfinite(hist))   # steps 0 and 2
    assert model.cfg.vocab_size == 32 and model.cfg.dtype == "float32"
    _, fresh = launch_train.model_and_params("tiny-lm", device="cpu",
                                             seed=5)
    back = checkpoint.load(path, fresh)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)


def test_train_launcher_tiny_variant():
    model, params = launch_train.model_and_params("llama3.2-1b", tiny=True,
                                                  device="cpu")
    assert model.cfg.name == "llama3.2-1b-tiny"
    assert model.cfg.n_layers == 2 and model.cfg.vocab_size == 32
    assert params["embed"].shape == (32, model.cfg.d_model)


def test_serve_launcher_finishes_every_request(capsys):
    out = launch_serve.main(["--device", "cpu", "--requests", "2",
                             "--train-steps", "3"])
    assert len(out["results"]) == 2 and out["report"]["n_finished"] == 2
    engine = out["backend"].engine
    assert engine.ecfg.attention == "tree"
    assert engine.alloc.used_pages == 0
    engine.alloc.check_invariants()
    text = capsys.readouterr().out
    assert "online serving (2 requests, refill" in text
    assert "accuracy" in text


@pytest.mark.parametrize("argv,match", [
    (["--replicas", "2", "--mesh", "1"], "replicas=2"),
    (["--mesh", "1"], "replicas=1"),
    (["--dry-run", "--arch", "hubert-xlarge"], "skip")])
def test_serve_launcher_leaves_out_replicas_and_meshes(argv, match, capsys):
    """What earlier slices left out now runs: engines on a host mesh
    (one gloo rank here), and the dry run (in a process of its own; the
    encoder's decode shape is a policy skip)."""
    if "--dry-run" in argv:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.startswith(match)
        return
    out = launch_serve.main(["--device", "cpu", "--requests", "2",
                             "--train-steps", "3", *argv])
    assert out["report"]["n_finished"] == 2
    assert all(b.engine.mesh is not None for b in out["backends"])
    assert match in capsys.readouterr().out


def test_train_launcher_leaves_out_the_dry_run(monkeypatch):
    """``--dry-run`` runs ``lower_combo`` at train_4k on the mesh asked
    for."""
    from repro_torch.launch import dryrun
    seen = []
    monkeypatch.setattr(dryrun, "lower_combo", lambda arch, shape, **kw: (
        seen.append((arch, shape, kw)) or {"status": "ok", "memory": {}}))
    rec = launch_train.main(["--dry-run", "--arch", "qwen3-14b",
                             "--multi-pod"])
    assert rec["status"] == "ok"
    assert seen == [("qwen3-14b", "train_4k", {"multi_pod": True})]


@pytest.mark.parametrize("main,argv", [
    (launch_serve.main, ["--shape", "decode_32k"]),
    (launch_serve.main, ["--multi-pod"]),
    (launch_train.main, ["--multi-pod"])])
def test_launchers_reject_dry_run_only_options(main, argv):
    # the reference's dry-run options are parsed, and act only with
    # --dry-run
    args = main.__globals__["parse_args"](argv)
    assert not args.dry_run
    assert getattr(args, argv[0][2:].replace("-", "_")) in (
        "decode_32k", True)


def test_example_prints_both_rows(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_and_search", ROOT / "examples" /
        "torch_train_and_search.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rows, info = example.main(["--device", "cpu", "--train-steps", "3",
                               "--problems", "1"])
    assert [r["method"] for r in rows] == ["rebase", "ets"]
    assert len(info["lm_history"]) == 2 and info["train_s"] > 0
    lines = capsys.readouterr().out.splitlines()
    for method in ("rebase", "ets"):
        assert any(ln.startswith(f"{method:8s} ") for ln in lines)


def test_backend_on_params_that_require_grad():
    """Scoring and embedding run under no_grad: params that require
    grad (as a training loop holds them) neither fail the host copies
    nor leak a graph into what the backend returns."""
    _, ((lm, lp), (prm, pp), (emb, ep)) = make_stacks(0)
    grad = lambda t: tree_map(  # noqa: E731
        lambda a: a.detach().clone().requires_grad_(True), t)
    lp, pp, ep = grad(lp), grad(pp), grad(ep)
    engine = PagedEngine(lm, lp, EngineConfig(n_pages=64, page_size=8,
                                              max_batch=8, max_seq_len=64),
                         device="cpu")
    backend = LMBackend(engine, prm, pp, emb, ep,
                        BackendConfig(step_token=NEWLINE, eos_token=EOS,
                                      max_step_tokens=6, max_depth=3),
                        answer_fn=ArithmeticTask.extract_answer,
                        device="cpu")
    tree = backend.start(encode("Q3+4\n"))
    ids = backend.expand_many(tree, [(0, 2)])
    scores = backend.score_many(tree, ids)
    solo = backend.score(tree, ids[0])
    embs = backend.embed_many(tree, ids)
    one = backend.embed(tree, ids[0])
    assert all(isinstance(x, float) for x in scores + [solo])
    assert isinstance(embs, np.ndarray) and isinstance(one, np.ndarray)
    assert embs.shape == (2, emb.cfg.d_model) and np.isfinite(embs).all()
    # the model itself still records autograd outside the backend
    r = prm.reward(pp, {"tokens": torch.tensor([encode("Q3+4\n")])})
    assert r.requires_grad


# ---------------------------------------------------------------------------
# The slice as a whole: train, then search, against the reference
# ---------------------------------------------------------------------------

PROMPTS = [encode("Q1+2*3-4\n"), encode("Q3+4\n"), encode("Q5*2-1*7\n")]


def test_train_then_search_matches_reference():
    """LM and PRM trained 20 steps from bridged params in both packages
    (the same batches), then a greedy ETS sweep in tree mode on each
    package's trained params: the same trees, rewards to rtol 1e-5."""
    jstack, tstack = make_stacks(0)
    task, jtask = ArithmeticTask(n_ops=3, seq_len=48), \
        JArithmeticTask(n_ops=3, seq_len=48)
    trained = {}
    for name, (jm, jp), (tm, tp) in (("lm", jstack[0], tstack[0]),
                                     ("prm", jstack[1], tstack[1])):
        jfit = jtraining.train_lm if name == "lm" else jtraining.train_prm
        tfit = train_lm if name == "lm" else train_prm
        jparams, _ = jfit(jm, jp, jtask, jtraining.TrainConfig(
            steps=20, batch=8, log_every=100))
        tparams, _ = tfit(tm, tp, task, TrainConfig(steps=20, batch=8,
                                                    log_every=100))
        trained[name] = (jparams, tparams)
    ets = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
    ekw = dict(n_pages=512, page_size=8, max_batch=16, max_seq_len=120,
               attention="tree")
    bkw = dict(step_token=NEWLINE, eos_token=EOS, max_step_tokens=10,
               max_depth=5)
    (jlm, _), (jprm, _), (jemb, jep) = jstack
    jbackend = JaxBackend(
        JaxEngine(jlm, trained["lm"][0], JaxEngineConfig(**ekw)), jprm,
        trained["prm"][0], jemb, jep, JaxBackendConfig(**bkw),
        answer_fn=JArithmeticTask.extract_answer)
    want = jax_run_search_many(jbackend, JaxSearchConfig(
        method="ets", width=4, max_steps=3, ets=JaxETSConfig(**ets)),
        PROMPTS)
    (tlm, _), (tprm, _), (temb, tep) = tstack
    tbackend = LMBackend(
        PagedEngine(tlm, trained["lm"][1], EngineConfig(**ekw),
                    device="cpu"), tprm, trained["prm"][1], temb, tep,
        BackendConfig(**bkw), answer_fn=ArithmeticTask.extract_answer,
        device="cpu")
    got = run_search_many(tbackend, SearchConfig(
        method="ets", width=4, max_steps=3, ets=ETSConfig(**ets)), PROMPTS)
    view = lambda r: [(n.parent, n.n_tokens, n.finished,  # noqa: E731
                       (n.payload or {}).get("tokens"),
                       (n.payload or {}).get("answer"))
                      for n in r.tree.nodes]
    for a, b in zip(want, got):
        assert view(a) == view(b)
        np.testing.assert_allclose([n.reward for n in b.tree.nodes],
                                   [n.reward for n in a.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert a.kv_summary["unique_pages_streamed"] == \
            b.kv_summary["unique_pages_streamed"]
    assert any(len(r.tree.nodes) > 4 for r in got)
    # training moved the params off the bridged start
    assert not torch.equal(trained["lm"][1]["ln_f"], tstack[0][1]["ln_f"])
    tbackend.engine.alloc.check_invariants()
    assert tbackend.engine.alloc.used_pages == 0
