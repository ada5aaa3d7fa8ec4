"""The port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points refuse to run on a missing card instead of
falling back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / name for name in (
        "chip_smoke.py", "calibrate_gemm.py", "paged_ticks.py",
        "sparse_decode_times.py", "gemm_times.py", "paged_times.py")]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_import_of_jax_or_the_jax_package(path):
    assert path.exists(), path
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15


def test_generate_without_a_card_raises(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve_lib import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    scfg = serve.ServeConfig(max_seq=8, batch=1, kernel_backend="hopper")
    assert scfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(params, cfg, scfg, torch.zeros(1, 4, dtype=torch.int32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.init_cache(cfg, scfg)


def test_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2-1.5b", "--smoke"])


def test_train_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-1.5b", "--smoke"])
