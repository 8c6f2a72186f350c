"""Adding a cell takes a configuration file, a traffic file and a
``workloads`` entry; adding a per-layer metric takes its reader file and
its entry.  In a copy of the benchmark, a new cell and a new metric are
added from files alone, and the harness finds them with no file that
was already there edited."""

import hashlib
import json
import shutil
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[1]


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_add_a_cell_and_a_metric_from_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)

    b = tmp_path / "bench"
    conf = json.loads((b / "configs" / "minitron-4b.json").read_text())
    conf["name"] = "minitron-4b-copy"
    (b / "configs" / "minitron-4b-copy.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "decode-heavy.json").read_text())
    traffic["params"]["output_len"] = [64, 128]
    (b / "traffic" / "short-answers.json").write_text(json.dumps(traffic))
    (b / "metrics" / "steps_in_window.short.py").write_text(
        "def read(ctx):\n"
        "    return sum(i['steps'] for i in ctx['iterations']) or None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "minitron-4b-copy", "source": "x",
                             "file": "bench/configs/minitron-4b-copy.json",
                             "reduced": conf["reduced"], "why": "a test"})
    name = "minitron-4b-copy.short-answers"
    bench["workloads"].append({"name": name, "config": "minitron-4b-copy",
                               "traffic": "short-answers", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_in_window.short",
                               "unit": "steps", "better": "higher",
                               "source": "program_counter",
                               "layer": "serve.batching",
                               "moves": "serve_tokens_per_s",
                               "workloads": [name]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())

    cell = harness.resolve(name, tmp_path)
    assert cell.config["name"] == "minitron-4b-copy"
    assert cell.traffic["params"]["output_len"] == [64, 128]
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window.short"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "serve_tokens_per_s"}
    read = harness.reader("steps_in_window.short", tmp_path)
    assert read({"iterations": [{"steps": 1}] * 3}) == 3
    specs = harness.generator(cell)(cell.traffic["params"], 1, vocab=100,
                                    slots=4)
    assert max(r["max_new"] for r in specs if not r["initial"]) <= 128
