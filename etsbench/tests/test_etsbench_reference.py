"""The plain reference against the port at tiny sizes, in float32 on the
CPU (this test may import both; the reference imports nothing of the
port)."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from etsbench import weights
from etsbench.reference import ets as ets_ref
from etsbench.reference import model as ref
from etsbench.reference import sampler as sref

from . import _tiny

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def _imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = _imports(path)
    assert not tops & {"repro", "repro_torch", "jax", "jaxlib", "flax"}
    assert tops <= {"__future__", "contextlib", "math", "typing", "numpy",
                    "torch", "scipy"}, tops


def _port(spec, head):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models.model import LM
    from etsbench.harness import _model_config
    cfg = _model_config(ModelConfig, MoEConfig, spec, "t")
    return LM(cfg, with_value_head=head == "value", device="cpu")


def _spec(kind, **kw):
    port = _tiny.configs()["tiny-moe" if kind == "moe" else
                           "tiny-dense"]["port"]
    s = dict(port["lm"], dtype="float32", **kw)
    return weights.spec_of(s)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_lm_logits_match_the_port(kind):
    spec = _spec(kind)
    if kind == "moe":     # dropless: capacity covers every token
        spec["moe"] = dict(spec["moe"], capacity_factor=2.0)
    w = weights.make(spec, "lm", 3, "cpu")
    toks = torch.randint(0, spec["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    got, _ = _port(spec, "lm").forward(w, {"tokens": toks})
    h = ref.hidden(w, spec, [toks[0].tolist()])[0]
    want = ref.logits_at(w, spec, h, torch.arange(40), "fp32")
    torch.testing.assert_close(got[0], want, atol=2e-5, rtol=2e-5)


def test_prm_reward_and_embedder_match_the_port():
    port = _tiny.configs()["tiny-dense"]["port"]
    spec = weights.spec_of(dict(port["prm"], dtype="float32"))
    w = weights.make(spec, "value", 4, "cpu")
    toks = torch.randint(0, 512, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    got = _port(spec, "value").reward(w, {"tokens": toks})[:, -1]
    hs = ref.hidden(w, spec, toks.tolist())
    want = ref.reward_of(w, torch.stack([h[-1] for h in hs]), "fp32")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    espec = weights.spec_of(port["embedder"])
    ew = weights.make(espec, "none", 5, "cpu")
    got = _port(espec, "none").hidden(ew, {"tokens": toks})
    for i, h in enumerate(ref.hidden(ew, espec, toks.tolist())):
        torch.testing.assert_close(got[i], h, atol=1e-5, rtol=1e-5)


def test_moe_bucket_with_drops_matches_the_port():
    """A padded PRM bucket under a capacity that drops replicas: the
    reference's capacity rule over the whole bucket is the port's."""
    spec = _spec("moe", n_layers=1)
    spec["moe"] = dict(spec["moe"], capacity_factor=0.5)
    w = weights.make(spec, "value", 6, "cpu")
    g = torch.Generator().manual_seed(2)
    lens = [13, 7, 16]
    toks = torch.zeros((4, 16), dtype=torch.long)
    pos = torch.full((4, 16), -1, dtype=torch.long)
    for r, n in enumerate(lens):
        toks[r, :n] = torch.randint(0, 512, (n,), generator=g)
        pos[r, :n] = torch.arange(n)
    got = _port(spec, "value").reward(w, {"tokens": toks,
                                          "positions": pos.int()})
    stats = {}
    h = ref.bucket_hidden(w, spec, toks, pos, "fp32", stats)
    assert stats["dropped"] > 0
    for r, n in enumerate(lens):
        want = ref.reward_of(w, h[r, n - 1][None], "fp32")[0]
        torch.testing.assert_close(got[r, n - 1], want, atol=1e-5,
                                   rtol=1e-5)


def test_draw_keys_and_noise_are_the_samplers():
    from repro_torch.serving import sampler as port
    seed = 2147483700 & 0xFFFFFFFF
    chain = port.key(seed)
    for step in (1, 2, 3):
        step_k = port.fold_in(chain, 1)
        chain = port.fold_in(chain, 0)
        assert tuple(int(x) for x in step_k) == sref.step_key(seed, step)
    rows = port.split(step_k, 5)
    k = rows[3]
    want = []
    for _ in range(4):
        nxt, sub = port.split_rows(k[None])
        want.append(tuple(int(x) for x in sub[0]))
        k = nxt[0]
    assert sref.draw_keys(seed, 3, 3, 4) == want
    g_port = port.gumbel(np.array(want, np.uint32), 300, "cpu").double()
    g_ref = sref.gumbel(want, 300, "cpu")
    torch.testing.assert_close(g_port, g_ref, atol=1e-5, rtol=1e-5)


def test_selection_is_etss():
    from repro_torch.core.ets import ETSConfig, ets_prune
    from repro_torch.core.tree import SearchTree
    rng = np.random.default_rng(7)
    for trial in range(12):
        tree = SearchTree(root_tokens=5)
        first = [tree.add(0, 8) for _ in range(4)]
        cands = [tree.add(int(rng.choice(first)), 8) for _ in range(10)]
        rewards = rng.uniform(0, 1, len(cands)).tolist()
        embs = rng.normal(size=(len(cands), 6))
        embs[1] = embs[0] + 0.01
        step = ets_prune(tree, cands, rewards, 16, ETSConfig(), embs)
        sel, counts = ets_ref.select([tree.path(c) for c in cands], rewards,
                                     embs, 16)
        assert sel == list(step.selected)
        assert counts == [int(c) for c in step.counts]


def test_fp8_control_reads_further_off_than_bfloat16():
    spec = _spec("dense")
    w = weights.make(spec, "lm", 8, "cpu")
    toks = torch.randint(0, 512, (30,),
                         generator=torch.Generator().manual_seed(3)).tolist()
    base = ref.hidden(w, spec, [toks], "fp32")[0]
    err = {p: float((ref.hidden(w, spec, [toks], p)[0] - base).abs().max())
           for p in ("bf16", "fp8")}
    assert 0 < err["bf16"] < err["fp8"]


def test_spec_of_fills_the_ports_defaults():
    from repro_torch.configs.base import ModelConfig
    spec = weights.spec_of({"arch_type": "dense", "n_layers": 1,
                            "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                            "d_ff": 8, "vocab_size": 16})
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=8, vocab_size=16)
    for k in ("head_dim", "norm_eps", "rope_theta", "act", "causal",
              "dtype"):
        assert spec[k] == getattr(cfg, k), k
    assert dataclasses.is_dataclass(cfg)
