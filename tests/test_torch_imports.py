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


def test_import_check_covers_the_mesh_slice():
    mesh = {"repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.private_serving"}
    assert mesh <= set(_port_modules())


def test_import_check_covers_the_serving_slice():
    serving = {"repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.model", "repro_torch.launch.serve",
               "repro_torch.kernels.swa_decode",
               "repro_torch.configs.registry"}
    assert serving <= set(_port_modules())


def test_import_check_covers_the_kernel_bench_slice():
    kernel_bench = {"repro_torch.launch.kernel_bench",
                    "repro_torch.launch.roofline",
                    "repro_torch.kernels.secure_agg",
                    "repro_torch.kernels.clip_accum",
                    "repro_torch.kernels.laplace"}
    assert kernel_bench <= set(_port_modules())


def test_import_check_covers_the_experiment_and_resilience_slice():
    slice_ = {"repro_torch.core.resilience.faults",
              "repro_torch.core.resilience.process",
              "repro_torch.core.resilience.runtime",
              "repro_torch.launch.fig2_convergence",
              "repro_torch.launch.noise_sweep",
              "repro_torch.launch.privacy_epsilon",
              "repro_torch.launch.dp_sweep",
              "repro_torch.launch.fault_sweep",
              "repro_torch.launch.resilience_demo"}
    assert slice_ <= set(_port_modules())

def test_import_check_covers_the_population_slice():
    slice_ = {"repro_torch.core.sampling",
              "repro_torch.data.partition",
              "repro_torch.core.population.population",
              "repro_torch.core.population.cohort",
              "repro_torch.core.population.engine",
              "repro_torch.launch.population_demo",
              "repro_torch.launch.population_scale"}
    assert slice_ <= set(_port_modules())


def test_import_check_covers_the_event_slice():
    slice_ = {"repro_torch.core.events.spec",
              "repro_torch.core.events.queue",
              "repro_torch.core.events.buffer",
              "repro_torch.core.events.engine",
              "repro_torch.launch.async_throughput"}
    assert slice_ <= set(_port_modules())


def test_import_check_covers_the_cross_cutting_slice():
    slice_ = {"repro_torch.sanitize",
              "repro_torch.core.specs",
              "repro_torch.core.fleet.spec",
              "repro_torch.checkpoint.io",
              "repro_torch.telemetry.schema",
              "repro_torch.telemetry.sinks",
              "repro_torch.telemetry.sketch",
              "repro_torch.telemetry.runlog",
              "repro_torch.telemetry.trace",
              "repro_torch.telemetry.stream",
              "repro_torch.telemetry.profile",
              "repro_torch.telemetry.watch",
              "repro_torch.telemetry.inspect",
              "repro_torch.launch.telemetry_overhead"}
    assert slice_ <= set(_port_modules())
    packages = {p.parent.relative_to(PORT).as_posix()
                for p in PORT.rglob("__init__.py")}
    assert {"telemetry", "checkpoint", "core/fleet",
            "core/privacy"} <= packages


def test_import_check_covers_the_fleet_slice():
    slice_ = {"repro_torch.core.fleet.namebook",
              "repro_torch.core.fleet.transport",
              "repro_torch.core.fleet.worker",
              "repro_torch.core.fleet.coordinator",
              "repro_torch.core.fleet.chaos",
              "repro_torch.launch.fleet_demo"}
    assert slice_ <= set(_port_modules())
    # the package's __init__, the seventh module, goes through the walk too
    assert PORT / "core" / "fleet" / "__init__.py" in _port_files()


def test_import_check_covers_the_moe_mla_slice():
    slice_ = {"repro_torch.models.moe",
              "repro_torch.configs.mixtral_8x7b",
              "repro_torch.configs.deepseek_v2_lite_16b",
              "repro_torch.configs.minicpm3_4b"}
    assert slice_ <= set(_port_modules())


def test_import_check_covers_the_ssm_rwkv_slice():
    slice_ = {"repro_torch.models.ssm",
              "repro_torch.models.rwkv",
              "repro_torch.configs.zamba2_1_2b",
              "repro_torch.configs.rwkv6_3b"}
    assert slice_ <= set(_port_modules())
    walked = set(_port_files())
    assert {PORT / "models" / "ssm.py", PORT / "models" / "rwkv.py"} <= walked


def test_import_check_covers_the_training_and_last_families_slice():
    slice_ = {"repro_torch.data.synthetic",
              "repro_torch.optim.clip",
              "repro_torch.optim.optimizers",
              "repro_torch.optim.schedules",
              "repro_torch.models.flat",
              "repro_torch.launch.federated_lm",
              "repro_torch.configs.llava_next_mistral_7b",
              "repro_torch.configs.whisper_tiny"}
    assert slice_ <= set(_port_modules())
    walked = set(_port_files())
    assert {PORT / "optim" / "__init__.py",
            PORT / "data" / "__init__.py"} <= walked


def test_federated_lm_without_card_raises(monkeypatch):
    from repro_torch.launch import federated_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated_lm.main(["--steps", "1"])


def test_fleet_demo_without_card_raises(monkeypatch):
    from repro_torch.launch import fleet_demo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_demo.main(["--transport", "inproc", "--ticks", "2"])


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


def test_kernel_bench_without_card_raises(monkeypatch):
    from repro_torch.launch import kernel_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main(["--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.micro_rows(reduced=True)


def test_rng_honours_seed_env(monkeypatch):
    from repro_torch import SEED_ENV, rng
    monkeypatch.setenv(SEED_ENV, "5")
    a = torch.rand(4, generator=rng(device="cpu"))
    b = torch.rand(4, generator=rng(5, device="cpu"))
    c = torch.rand(4, generator=rng(6, device="cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
