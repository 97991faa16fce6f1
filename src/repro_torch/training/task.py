"""Trainable synthetic task: chained mod-10 arithmetic with step-by-step
solutions.

Format (char-level):
    prompt : "Q3+4*2\n"
    steps  : ">3+4=7\n"  ">7*2=4\n"
    final  : "A4\n<EOS>"

Every step is verifiable, so PRM training labels (is-the-prefix-correct)
are generated programmatically, and search answers are checkable.  This is
the trainable counterpart of ``repro_torch.core.synthetic`` — the end-to-end
example trains the tiny LM + PRM here and runs the full ETS search stack
against them (examples/torch_train_and_search.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

PAD, EOS = 0, 1
_CHARS = "0123456789+-*=>QA\n"
CHAR_TO_ID = {c: i + 2 for i, c in enumerate(_CHARS)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}
VOCAB_SIZE = len(_CHARS) + 2
NEWLINE = CHAR_TO_ID["\n"]


def encode(text: str) -> List[int]:
    return [CHAR_TO_ID[c] for c in text]


def decode(tokens) -> str:
    return "".join(ID_TO_CHAR.get(int(t), "") for t in tokens
                   if int(t) not in (PAD, EOS))


def _apply(op: str, a: int, b: int) -> int:
    if op == "+":
        return (a + b) % 10
    if op == "-":
        return (a - b) % 10
    return (a * b) % 10


@dataclass
class ArithmeticTask:
    n_ops: int = 3                 # chain length (number of steps)
    seq_len: int = 64              # padded training length
    seed: int = 0

    def sample_problem(self, rng) -> Tuple[str, List[str], int]:
        """Returns (prompt, correct steps, final answer)."""
        vals = [int(rng.integers(10))]
        ops, operands = [], []
        for _ in range(self.n_ops):
            ops.append("+-*"[rng.integers(3)])
            operands.append(int(rng.integers(10)))
        prompt = "Q" + str(vals[0]) + "".join(
            o + str(b) for o, b in zip(ops, operands)) + "\n"
        steps, cur = [], vals[0]
        for o, b in zip(ops, operands):
            new = _apply(o, cur, b)
            steps.append(f">{cur}{o}{b}={new}\n")
            cur = new
        return prompt, steps, cur

    # ------------------------------------------------------------------
    def lm_batch(self, rng, batch: int) -> Dict[str, np.ndarray]:
        """Teacher-forced LM batch: tokens, labels (next-token), mask."""
        toks = np.full((batch, self.seq_len), PAD, np.int64)
        for b in range(batch):
            prompt, steps, ans = self.sample_problem(rng)
            text = prompt + "".join(steps) + f"A{ans}\n"
            ids = encode(text) + [EOS]
            ids = ids[: self.seq_len]
            toks[b, : len(ids)] = ids
        labels = np.full_like(toks, PAD)
        labels[:, :-1] = toks[:, 1:]
        mask = (labels != PAD).astype(np.float32)
        return {"tokens": toks, "labels": labels, "loss_mask": mask}

    # ------------------------------------------------------------------
    def prm_batch(self, rng, batch: int,
                  corrupt_p: float = 0.5) -> Dict[str, np.ndarray]:
        """PRM batch: trajectories (some corrupted mid-chain) + per-token
        prefix-correctness labels."""
        toks = np.full((batch, self.seq_len), PAD, np.int64)
        labels = np.zeros((batch, self.seq_len), np.float32)
        mask = np.zeros((batch, self.seq_len), np.float32)
        for b in range(batch):
            prompt, steps, ans = self.sample_problem(rng)
            corrupt_at = None
            if rng.random() < corrupt_p:
                corrupt_at = int(rng.integers(len(steps)))
            text_parts = [prompt]
            ok_flags = [True] * len(encode(prompt))
            correct = True
            cur_ans = ans
            for si, s in enumerate(steps):
                if corrupt_at is not None and si == corrupt_at:
                    # corrupt the step's result digit
                    wrong = s[:-2] + str((int(s[-2]) + 1 +
                                          int(rng.integers(8))) % 10) + "\n"
                    s = wrong
                    correct = False
                text_parts.append(s)
                ok_flags += [correct] * len(encode(s))
            final = f"A{cur_ans if correct else (cur_ans + 1) % 10}\n"
            # (a corrupted chain rarely lands on the right final answer)
            text_parts.append(final)
            ok_flags += [correct] * (len(encode(final)) + 1)  # + EOS
            ids = encode("".join(text_parts)) + [EOS]
            ids = ids[: self.seq_len]
            ok_flags = ok_flags[: len(ids)]
            toks[b, : len(ids)] = ids
            labels[b, : len(ids)] = np.asarray(ok_flags, np.float32)
            mask[b, : len(ids)] = 1.0
        return {"tokens": toks, "labels": labels, "loss_mask": mask}

    # ------------------------------------------------------------------
    @staticmethod
    def extract_answer(tokens) -> Optional[int]:
        """Parse 'A<digit>' near the end of a trajectory."""
        text = decode(tokens)
        for line in reversed(text.split("\n")):
            if line.startswith("A") and len(line) >= 2 and line[1].isdigit():
                return int(line[1])
        return None

    @staticmethod
    def check_trajectory(tokens) -> bool:
        """Oracle: is every step of the trajectory arithmetically right?"""
        text = decode(tokens)
        lines = [l for l in text.split("\n") if l]
        if not lines or not lines[0].startswith("Q"):
            return False
        for line in lines[1:]:
            if line.startswith(">") and "=" in line:
                try:
                    lhs, rhs = line[1:].split("=")
                    a, op, b = lhs[0], lhs[1], lhs[2]
                    if _apply(op, int(a), int(b)) != int(rhs[0]):
                        return False
                except (ValueError, IndexError):
                    return False
        return True
