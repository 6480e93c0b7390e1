"""The port imports neither JAX nor the JAX reference package.

Every module under ``src/repro_torch/`` must import in a process where
``jax`` and ``repro`` cannot be imported at all, and no file there (nor
``chip_smoke.py``) may name them in an import statement.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.models.ssm",
            "repro_torch.kernels.ssm_scan", "repro_torch.kernels.ops",
            "repro_torch.configs.rwkv6_7b"} <= set(mods) and len(mods) > 20
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
            "None and (m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'jaxlib', 'repro.'))))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_IMPORT = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                     r"(\.|\s+import\b))", re.M)


def test_no_source_names_jax_or_the_reference_in_an_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in _IMPORT.finditer(p.read_text())]
    assert not offenders, offenders
