"""The port stands alone: it imports neither jax nor the reference package,
and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _port_modules():
    return sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_import_check_covers_the_serving_slice():
    serving = {"repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.model", "repro_torch.launch.serve",
               "repro_torch.kernels.swa_decode",
               "repro_torch.configs.registry"}
    assert serving <= set(_port_modules())


def test_importing_the_port_leaves_jax_out():
    mods = _port_modules()
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_request_without_card_raises(monkeypatch):
    from repro_torch import resolve_device, rng
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rng(0)
    assert resolve_device("cpu").type == "cpu"


def test_rng_honours_seed_env(monkeypatch):
    from repro_torch import SEED_ENV, rng
    monkeypatch.setenv(SEED_ENV, "5")
    a = torch.rand(4, generator=rng(device="cpu"))
    b = torch.rand(4, generator=rng(5, device="cpu"))
    c = torch.rand(4, generator=rng(6, device="cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
