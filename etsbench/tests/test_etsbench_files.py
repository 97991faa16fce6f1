"""A new configuration, traffic mix and per-layer metric are taken as
new files and entries, with no edit to a file that is there."""
import hashlib
import json

from . import _tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "etsbench").rglob("*")) if p.is_file()}


def test_new_files_are_found_without_an_edit(tmp_path):
    root = _tiny.make_root(tmp_path)
    before = _digests(root)
    base = root / "etsbench"
    cfg = _tiny.configs()["tiny-dense"]
    cfg["port"]["lm"]["n_layers"] = 1
    (base / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny-new.json").write_text(
        json.dumps(dict(_tiny.MIX, max_live=3, problem_tokens=[4, 12])))
    (base / "limits" / "tiny-new.tiny-new.json").write_text(
        json.dumps({"limits": _tiny.LIMITS}))
    (base / "metrics" / "decode.steps_per_s.py").write_text(
        "def read(m):\n"
        "    return m['counters']['decode_steps'] / m['window_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-new", "source": "test",
                             "file": "etsbench/configs/tiny-new.json",
                             "reduced": ["num_hidden_layers"], "why": "t"})
    bench["workloads"].append({"name": "tiny-new.tiny-new",
                               "config": "tiny-new", "traffic": "tiny-new",
                               "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "decode.steps_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine decode",
                               "moves": "search_tok_s",
                               "workloads": ["tiny-new.tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _tiny.run(root, "tiny-new.tiny-new", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["decode.steps_per_s"]["value"] > 0
    # rows per iteration: the new mix's 3 problems x width 4 at most
    assert res["metrics"]["decode.rows_per_iter"]["value"] <= 12
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    # the old cells do not read the new metric
    old = _tiny.run(root, _tiny.DENSE, trace=1)
    assert "decode.steps_per_s" not in old["metrics"]
