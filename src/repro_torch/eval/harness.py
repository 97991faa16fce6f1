"""lm-eval-style answer-checking harness for search accuracy.

Turns ``SearchResult.answer`` into a first-class, tested accuracy
metric.  The shape follows lm-eval: a *task* owns its documents and its
answer check; a *runner* drives the search stack over the documents and
aggregates metrics.  Tasks register by name so benchmarks and CLIs
select them with a string, and a new (real) task plugs in without
touching the runner:

    @register_task("my-dataset")
    class MyTask(EvalTask):
        def docs(self, n, seed): ...
        def check(self, pred, gold): ...

Two task families ship here:

  * ``synthetic``  — the oracle search-dynamics task
    (``repro_torch.core.synthetic``).  Each document IS its own Backend, so
    the runner drives the sweep scheduler over a ``SyntheticSweep`` —
    uniform or difficulty-adaptive — with zero model weights involved.
    This is what the BENCH ``adaptive`` accuracy-vs-tokens frontier
    runs on.
  * ``arithmetic`` — the trainable chained mod-10 task
    (``repro_torch.training.task``).  Documents are token prompts + gold
    integers; the runner needs a prompt-driven backend (the LM engine),
    showing the real-task path through the same interface.

``run_eval`` reports accuracy and *total generated tokens* — the
compute axis of the frontier — measured by the backend when it can
(``problem_gen_tokens``) and tree-derived otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.controllers import (AdaptiveConfig, SearchConfig, SearchResult,
                                SweepScheduler, run_search_many)
from ..core.synthetic import (SyntheticProblem, SyntheticSweep,
                              SyntheticTaskConfig)

__all__ = [
    "EvalDoc", "EvalTask", "EvalReport", "register_task", "get_task",
    "list_tasks", "SyntheticEvalTask", "ArithmeticEvalTask", "run_eval",
]


@dataclass
class EvalDoc:
    """One evaluation document.

    Oracle tasks attach a ``problem`` (a Backend-implementing instance
    whose tree the search explores); prompt tasks attach token
    ``prompt``s for an external backend.  ``gold`` is what the task's
    ``check`` compares the search answer against.
    """
    gold: Any
    problem: Optional[Any] = None          # oracle mode: doc IS a backend
    prompt: Optional[Sequence[int]] = None  # prompt mode: tokens for an LM
    meta: Dict[str, Any] = field(default_factory=dict)


class EvalTask:
    """Base task: documents + answer check (exact match by default)."""

    name = "?"

    def docs(self, n: int, seed: int = 0) -> List[EvalDoc]:
        raise NotImplementedError

    def check(self, pred: Any, gold: Any) -> bool:
        """Is the search's answer correct?  Exact match by default;
        tasks override for normalized / numeric comparisons."""
        return pred is not None and pred == gold


_REGISTRY: Dict[str, Callable[..., EvalTask]] = {}


def register_task(name: str):
    """Class decorator: make a task constructible by name."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_task(name: str, **kwargs) -> EvalTask:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown eval task {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_tasks() -> List[str]:
    return sorted(_REGISTRY)


@register_task("synthetic")
class SyntheticEvalTask(EvalTask):
    """The oracle search-dynamics task as an eval task.

    Documents are independently-seeded :class:`SyntheticProblem`
    instances (seed chain matches ``evaluate_method``'s, so accuracies
    are comparable across harnesses); gold is the oracle's
    ``correct_answer``.
    """

    def __init__(self, cfg: Optional[SyntheticTaskConfig] = None):
        self.cfg = cfg or SyntheticTaskConfig()

    def docs(self, n: int, seed: int = 0) -> List[EvalDoc]:
        return [EvalDoc(problem=SyntheticProblem(self.cfg,
                                                 seed=seed * 100003 + i),
                        gold="ANS_TRUE") for i in range(n)]


@register_task("arithmetic")
class ArithmeticEvalTask(EvalTask):
    """The trainable chained mod-10 arithmetic task (real-task path).

    Documents are encoded prompts for a prompt-driven backend (the LM
    engine trained by ``repro_torch.training``); gold is the chain's final
    value.  ``check`` is numeric equality on the parsed ``A<digit>``.
    """

    def __init__(self, n_ops: int = 3):
        from ..training.task import ArithmeticTask, encode
        self.task = ArithmeticTask(n_ops=n_ops)
        self._encode = encode

    def docs(self, n: int, seed: int = 0) -> List[EvalDoc]:
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            prompt, _steps, ans = self.task.sample_problem(rng)
            out.append(EvalDoc(prompt=self._encode(prompt), gold=ans,
                               meta={"prompt_text": prompt}))
        return out


@dataclass
class EvalReport:
    """Aggregated harness output (one point on the accuracy frontier)."""
    task: str
    n: int
    accuracy: float
    total_gen_tokens: int
    gen_tokens_per_doc: float
    results: List[SearchResult]
    correct: List[bool]


def _gen_tokens(res: SearchResult, backend) -> int:
    """Generated tokens one search spent: backend-measured when the
    backend keeps a per-problem ledger, else tree-derived (every
    non-root node's tokens were decoded by some step)."""
    fn = getattr(backend, "problem_gen_tokens", None)
    if fn is not None:
        return int(fn(res.tree))
    root = res.tree.node(0).n_tokens
    return int(sum(nd.n_tokens for nd in res.tree.nodes) - root)


def run_eval(task: EvalTask, scfg: SearchConfig, *, n: int = 50,
             seed: int = 0, adaptive: Optional[AdaptiveConfig] = None,
             backend: Optional[Any] = None,
             max_live: Optional[int] = None) -> EvalReport:
    """Drive the search stack over a task's documents; score answers.

    Oracle documents (``doc.problem``) run through a
    :class:`SyntheticSweep` + :class:`SweepScheduler` — the same
    cross-problem batching the benchmarks measure — while prompt
    documents require a ``backend`` (LM engine) and run through
    ``run_search_many``.  ``adaptive`` threads the difficulty-adaptive
    budget controller through either path.
    """
    documents = task.docs(n, seed=seed)
    if not documents:
        raise ValueError("task produced no documents")
    oracle = documents[0].problem is not None
    if oracle:
        sweep = SyntheticSweep([d.problem for d in documents])
        sched = SweepScheduler(sweep, scfg, trees=sweep.make_trees(),
                               max_live=max_live, adaptive=adaptive)
        results = sched.run()
        spent = [int(d.problem.gen_tokens) for d in documents]
    else:
        if backend is None:
            raise ValueError(
                f"task {task.name!r} has prompt documents; pass backend=")
        results = run_search_many(backend, scfg,
                                  [list(d.prompt) for d in documents],
                                  max_live=max_live, adaptive=adaptive)
        spent = [_gen_tokens(r, backend) for r in results]
    correct = [task.check(r.answer, d.gold)
               for r, d in zip(results, documents)]
    total = int(sum(spent))
    return EvalReport(task=task.name, n=len(documents),
                      accuracy=float(np.mean(correct)),
                      total_gen_tokens=total,
                      gen_tokens_per_doc=total / len(documents),
                      results=results, correct=correct)
