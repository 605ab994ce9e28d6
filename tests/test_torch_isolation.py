"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor anything of the reference package `repro`."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_port_modules_import_without_jax_or_reference():
    assert len(MODULES) >= 20
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or "
            "k == 'repro' or k.startswith('repro.') "
            "for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_name_jax_or_reference():
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
        re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("import jax.numpy as jnp")
    assert pattern.search("from repro.core import serve")
    assert not pattern.search("from repro_torch.core import serve")


def test_multi_shard_slice_modules_are_covered():
    """The baselines, the data pipeline, the sharding rules and the Router
    are among the modules imported above with JAX and `repro` blocked."""
    for m in ("repro_torch.baselines.zm", "repro_torch.baselines.rstar",
              "repro_torch.baselines.flood", "repro_torch.baselines.fnz",
              "repro_torch.data.pipeline", "repro_torch.dist.sharding",
              "repro_torch.api.exec.router", "repro_torch.api.engines",
              "repro_torch.core.serve", "repro_torch.serving.server"):
        assert m in MODULES, m


def test_cost_model_modules_are_covered():
    """The analyzer and step counter, the roofline and the dry-run tools
    are among the modules imported above with JAX and `repro` blocked."""
    for m in ("repro_torch.dist.hlo_analysis", "repro_torch.dist.roofline",
              "repro_torch.launch.dryrun", "repro_torch.launch.report",
              "repro_torch.launch.attribute",
              "repro_torch.launch.reanalyze"):
        assert m in MODULES, m
