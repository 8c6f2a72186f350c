"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference loads nothing of the program.  Each check runs in a
fresh interpreter, since the test process itself has JAX loaded."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("from bench import run, runner, serve, harness, weights, "
                  "device, counts, smoke, train, control\n"
                  "from bench.generators import backlog, train_tokens\n"
                  "from bench import harness as H\n"
                  "[H.reader(m['name']) for m in "
                  "json.load(open('BENCHMARK.json'))['per_layer']]\n"
                  "import repro_torch.serve.batching, "
                  "repro_torch.kernels.build")
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods
    assert "repro_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from bench.reference import model")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, mods
