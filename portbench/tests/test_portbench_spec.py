"""BENCHMARK.json names files that exist and keeps to the contract's
shapes; the harness finds configurations, mixes and metric readers by
name, so a later cell adds files and entries and edits none."""

import ast
import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_files():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"]
    for c in s["configs"]:
        assert NAME.match(c["name"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        for k in c["reduced"]:
            assert k in conf and NAME.match(k)
        assert conf["reduced"] == c["reduced"]
    names = {c["name"] for c in s["configs"]}
    for w in s["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in s["workloads"]]
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in s["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports the metric reports what it moves
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_reader_says_why_and_reads_nothing_as_none():
    empty = {"window_s": 1.0, "reads": 0, "mbp": 1.0, "spans": {},
             "batch_s": [], "port_trace": {},
             "counters": {"global_chained": 0, "global_declined": 0},
             "work": {}}
    from yardstick.cell import load_reader

    for path in (BENCH / "metrics").glob("*.py"):
        assert ast.get_docstring(ast.parse(path.read_text())), path
        value = load_reader(path.stem)(dict(empty))
        assert value is None or path.stem == "seeding.busy_frac", path
