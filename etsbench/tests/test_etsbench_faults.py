"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted after the ramp, inside the program (never in the
benchmark's probes), and the run is otherwise the cell's as the
harness drives it, on the CPU at tiny sizes.  The faults a one-card
serving cell can have: a step that leaves its state unchanged (the
decode's K/V writes lost), half of a batch left out (the PRM scores
half its rows and gives the rest their mean), a token altered where it
is produced (the sampler), an answer altered where it is produced (the
selection).  There is no exchange between cards to leave out.
"""
import pytest
import torch

from . import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("bench"))


def _state_unchanged(engine, backend):
    step = engine._decode_step

    def kept(*a, **k):
        k0, v0 = engine.pool.k.clone(), engine.pool.v.clone()
        out = step(*a, **k)
        engine.pool.k.copy_(k0)
        engine.pool.v.copy_(v0)
        return out
    engine._decode_step = kept


def _half_batch(engine, backend):
    model = backend.prm_model
    reward = model.reward

    def half(params, batch):
        toks = batch["tokens"]
        n = max(toks.shape[0] // 2, 1)
        r = reward(params, {k: v[:n] for k, v in batch.items()})
        rest = r.mean(dim=0, keepdim=True).expand(toks.shape[0] - n, -1)
        return torch.cat([r, rest])
    model.reward = half


def _token_altered(engine, backend):
    import repro_torch.serving.engine as E
    sample = E.sample_tokens_rowwise
    vocab = engine.cfg.vocab_size

    def altered(keys, logits, temperature=1.0):
        return (sample(keys, logits, temperature) + 1) % vocab
    E.sample_tokens_rowwise = altered
    return lambda: setattr(E, "sample_tokens_rowwise", sample)


def _answer_altered(engine, backend):
    import repro_torch.core.ets as ets
    solve = ets.solve

    def altered(prob, method="milp"):
        res = solve(prob, method)
        keep = [i for i in range(len(prob.leaf_values))
                if i not in res.selected]
        res.selected = keep[:1] if keep else res.selected
        return res
    ets.solve = altered
    return lambda: setattr(ets, "solve", solve)


FAULTS = {"state_unchanged": (_state_unchanged, "lm"),
          "half_batch": (_half_batch, "prm"),
          "token_altered": (_token_altered, "lm"),
          "answer_altered": (_answer_altered, "ets")}
# the number each cell compares for each model
CHECKS = {_tiny.DENSE: {"lm": "lm_gap", "prm": "prm_gap",
                        "ets": "ets_mismatch"},
          _tiny.MOE: {"lm": "lm_gap_p99", "prm": "prm_mean_gap",
                      "ets": "ets_mismatch"}}


@pytest.mark.parametrize("cell", [_tiny.DENSE, _tiny.MOE])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    plant, model = FAULTS[fault]
    check = CHECKS[cell][model]
    undo = []

    def faults(engine, backend):
        u = plant(engine, backend)
        if u:
            undo.append(u)
    try:
        res = _tiny.run(root, cell, faults=faults, seconds=2.0)
    finally:
        for u in undo:
            u()
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]
