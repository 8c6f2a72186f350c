"""The port stands alone: ``src/repro_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of ``repro``, and the port's serving
CLI runs end to end on the CPU."""

import ast
import os
import pathlib
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


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
