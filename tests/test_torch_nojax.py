"""The port stands alone: it imports neither JAX nor the reference."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_port_imports_without_jax():
    """Every repro_torch module and chip_smoke import with ``jax``
    blocked in ``sys.modules`` (chip_smoke is imported, not run)."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        "import importlib",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert len(_port_modules()) >= 16
    assert {"repro_torch.board", "repro_torch.board.route",
            "repro_torch.routeopt", "repro_torch.core.packets",
            "repro_torch.learn", "repro_torch.learn.engine",
            "repro_torch.learn.adaptive", "repro_torch.obs.probes",
            "repro_torch.obs.trace", "repro_torch.obs.spans",
            "repro_torch.obs.metrics", "repro_torch.obs.health",
            "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.serve", "repro_torch.serve.queue",
            "repro_torch.serve.fleet", "repro_torch.serve.fleet.engine",
            "repro_torch.serve.fleet.scenarios",
            "repro_torch.serve.fleet.sessions",
            "repro_torch.serve.fleet.traffic", "repro_torch.launch.fleet",
            "repro_torch.core.hybrid", "repro_torch.obs.report",
            "repro_torch.obs.manifest", "repro_torch.routeopt.profile",
            "repro_torch.routeopt.invariants",
            "repro_torch.routeopt.optimize", "repro_torch.configs.base",
            "repro_torch.configs.glm4_9b", "repro_torch.configs.qwen15_4b",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.models", "repro_torch.models.moe",
            "repro_torch.models.registry", "repro_torch.configs.olmoe",
            "repro_torch.configs.phi35_moe",
            "repro_torch.configs.gemma3_27b",
            "repro_torch.configs.nemotron4_15b",
            "repro_torch.configs.chameleon_34b",
            "repro_torch.configs.musicgen_large",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.rwkv6_1b6", "repro_torch.models.rglru",
            "repro_torch.models.rwkv6", "repro_torch.kernels.linear_scan",
            "repro_torch.kernels.linear_scan.ops",
            "repro_torch.kernels.linear_scan.ref",
            "repro_torch.kernels.wkv6", "repro_torch.kernels.wkv6.ops",
            "repro_torch.kernels.wkv6.ref"} <= set(_port_modules())


def test_port_sources_do_not_name_the_reference():
    pattern = re.compile(r"^\s*(import\s+(repro|jax)\b(?!_torch)"
                         r"|from\s+(repro|jax)(\.|\s))", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p}: {m.group(0).strip()}" for p in files
            for m in pattern.finditer(p.read_text())]
    assert not hits, hits
