"""The port stands alone: ``src/repro_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of ``repro``, and the port's serving
CLI runs end to end on the CPU."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


TRAINING = ("train/optimizer.py", "train/train_loop.py", "train/data.py",
            "train/checkpoint.py", "train/fault.py", "launch/train.py",
            "examples/train_lm.py")


def test_training_modules_exist_and_stand_alone():
    """The training path's modules are in the package, so the two tests
    above cover them: no import of ``jax`` or ``repro`` in their source,
    and each imports with both blocked."""
    files = set(PKG.rglob("*.py"))
    for rel in TRAINING:
        assert PKG / rel in files, rel
        mods = set(_imported_modules(PKG / rel))
        assert not {m.split(".")[0] for m in mods} & {"jax", "repro"}, rel


ROOFLINE = ("roofline/hw.py", "roofline/count.py", "roofline/analysis.py",
            "launch/dryrun.py", "launch/sweep_optimized.py")


def test_roofline_modules_exist_and_stand_alone():
    """The roofline and dry-run modules are in the package, so the two
    import tests above cover them too: no import of ``jax`` or ``repro``
    in their source."""
    files = set(PKG.rglob("*.py"))
    for rel in ROOFLINE:
        assert PKG / rel in files, rel
        mods = set(_imported_modules(PKG / rel))
        assert not {m.split(".")[0] for m in mods} & {"jax", "repro"}, rel


def _serve(*extra, arch="minitron-4b", prompt_len=10):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--smoke", "--device", "cpu", "--requests", "4",
         "--slots", "2", "--prompt-len", str(prompt_len), "--max-new", "5",
         "--max-seq", "48", *extra],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)


@pytest.mark.parametrize("extra", [
    ("--page-size", "8", "--decode-flash"),
    ("--page-size", "8", "--pages", "3"),
    (),                                       # dense slots, the default
    ("--decode-flash",),
    ("--kv-cache-dtype", "int8"),
    ("--kv-cache-dtype", "int8", "--page-size", "8", "--decode-flash"),
])
def test_serve_cli_runs_and_prints_summary(extra):
    out = _serve(*extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 4
    assert "4 requests, 20 tokens in" in lines[-1]
    mode = "paged(page=8," if "--page-size" in extra else ", dense,"
    assert mode in lines[-1]


@pytest.mark.parametrize("extra", [
    ("--page-size", "8", "--decode-flash"),
    ("--decode-flash",),
    ("--page-size", "8", "--prefix-cache", "--speculate"),
])
def test_serve_cli_gemma3(extra):
    """gemma3-12b serves paged and dense, prompts past the smoke window
    (24 > 16); its ring layout serves with the prefix cache off."""
    out = _serve(*extra, arch="gemma3-12b", prompt_len=24)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 4
    assert "4 requests, 20 tokens in" in lines[-1]
    mode = "paged(page=8,pool=global:" if "--page-size" in extra \
        else ", dense,"
    assert mode in lines[-1]
    assert not any(line.startswith("prefix-cache:") for line in lines)


@pytest.mark.parametrize("arch,extra", [
    ("phi3p5-moe-42b", ("--page-size", "8", "--decode-flash")),
    ("phi3p5-moe-42b", ("--kv-cache-dtype", "int8", "--decode-flash")),
    ("deepseek-v2-lite-16b", ("--page-size", "8", "--prefix-cache",
                              "--speculate")),
    ("deepseek-v2-lite-16b", ()),             # dense slots
])
def test_serve_cli_moe_family(arch, extra):
    """phi3.5-moe and deepseek (MLA latent pages) serve through the CLI,
    paged and from dense slots."""
    out = _serve(*extra, arch=arch, prompt_len=12)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 4
    assert "4 requests, 20 tokens in" in lines[-1]
    mode = "paged(page=8,pool=" if "--page-size" in extra else ", dense,"
    assert mode in lines[-1]
    if arch.startswith("deepseek") and "--page-size" in extra:
        assert "pool=latent:" in lines[-1]
        assert any(line.startswith("prefix-cache:") for line in lines)


@pytest.mark.parametrize("extra", [
    ("--page-size", "8", "--metrics-port", "0", "--trace-out", "t.json"),
    ("--page-size", "8", "--trace-out", "t.jsonl", "--profile"),
    ("--metrics-port", "0",),                 # dense slots, no trace
])
def test_serve_cli_telemetry(tmp_path, extra):
    """The telemetry flags: ``metrics:`` with the URL first, then the
    summary, the ``latency:`` line over the 4 requests and the ``trace:``
    line; the trace file holds that many events, one submit per
    request."""
    extra = [str(tmp_path / a) if a.startswith("t.") else a for a in extra]
    out = _serve(*extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("metrics: http://127.0.0.1:") == (
        "--metrics-port" in extra)
    summary = next(i for i, line in enumerate(lines)
                   if line.startswith("4 requests, 20 tokens in"))
    latency = lines[summary + 1]
    assert latency.startswith("latency: ttft p50 ")
    assert latency.endswith("(bucket-derived, n=4)")
    trace = [a for a in extra if a.startswith(str(tmp_path))]
    if not trace:
        assert len(lines) == summary + 2
        return
    m = re.fullmatch(r"trace: (\d+) events -> (.+) \((chrome|JSONL) trace; "
                     r"0 dropped\)", lines[summary + 2])
    assert m and m.group(2) == trace[0]
    text = pathlib.Path(trace[0]).read_text()
    if m.group(3) == "chrome":
        events = json.loads(text)["traceEvents"]
        rids = [e["args"]["rid"] for e in events if e["name"] == "submit"]
    else:
        events = [json.loads(line) for line in text.splitlines()]
        rids = [e["rid"] for e in events if e["name"] == "submit"]
    assert len(events) == int(m.group(1))
    assert sorted(rids) == [0, 1, 2, 3]


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_serve_cli_refuses_vlm_and_audio(arch):
    """The port's CLI refuses the vlm and audio families as the
    reference's CLI does: a non-zero exit with the batcher's
    ``NotImplementedError`` as the last line of standard error, and no
    request served."""
    outs = [subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch.serve", "--arch", arch,
         "--smoke", "--requests", "2", "--slots", "2", "--prompt-len", "4",
         "--max-new", "2", "--max-seq", "16", *extra],
        env=dict(_env(), JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=120, cwd=ROOT)
        for pkg, extra in (("repro_torch", ("--device", "cpu")),
                           ("repro", ()))]
    for out in outs:
        assert out.returncode == 1, out.stderr
        assert out.stderr.strip().splitlines()[-1] == (
            "NotImplementedError: batcher demo covers LM families")
        assert not any(line.startswith("req ")
                       for line in out.stdout.splitlines())


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
