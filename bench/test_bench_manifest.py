"""``BENCHMARK.json`` against the contract's form: its keys, names and
units in their characters, every cell found from its entry alone, every
per-layer metric with a reader, every configuration used, and every
cell with a limit for ``correct``."""

import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(B["command"]) <= 32
    assert B["command"][1].startswith(B["paths"][0] + "/")
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keys_names_and_units():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(B["paths"][0] + "/")
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"]
        assert all(k in f["published"] for k in c["reduced"])
        # no width is ever cut
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       or "experts_per_tok" in k for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_resolves_and_reports():
    used = set()
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for w in B["workloads"]:
        cell = harness.resolve(w["name"], ROOT)
        used.add(w["config"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])
        assert runner_limits(cell), w["name"]
    assert used == {c["name"] for c in B["configs"]}


def runner_limits(cell):
    from bench import runner
    return runner.limits(cell)


@pytest.mark.parametrize("m", [m["name"] for m in B["per_layer"]])
def test_readers_load(m):
    assert callable(harness.reader(m, ROOT))
