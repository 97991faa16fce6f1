"""Answer-checking evaluation harness (lm-eval-style tasks + runner).

``run_eval`` drives the search stack over a registered task's documents
and reports accuracy plus total generated tokens — the two axes of the
accuracy-vs-compute frontier the adaptive BENCH section plots.  See
``repro_torch.eval.harness`` for the task registry and the shipped tasks
(``synthetic``, ``arithmetic``).
"""
from .harness import (ArithmeticEvalTask, EvalDoc, EvalReport, EvalTask,
                      SyntheticEvalTask, get_task, list_tasks,
                      register_task, run_eval)

__all__ = [
    "ArithmeticEvalTask", "EvalDoc", "EvalReport", "EvalTask",
    "SyntheticEvalTask", "get_task", "list_tasks", "register_task",
    "run_eval",
]
