"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of classpro_tpu_torch (and
chip_smoke.py) and must end with no ``jax*`` and no ``classpro_tpu`` /
``classpro_tpu.*`` key in sys.modules.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "classpro_tpu_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_port_imports_no_jax():
    mods = _modules()
    assert "classpro_tpu_torch.kernels" in mods and len(mods) >= 15
    code = "\n".join(
        ["import importlib, sys", f"sys.path.insert(0, {str(ROOT)!r})"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["import chip_smoke",
           "bad = sorted(k for k in sys.modules if k == 'jax' or "
           "k.startswith(('jax.', 'jaxlib')) or k == 'classpro_tpu' or "
           "k.startswith('classpro_tpu.'))",
           "print(bad)", "sys.exit(1 if bad else 0)"])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_package():
    """No source of the port (nor chip_smoke.py) mentions an import of
    jax or of classpro_tpu's modules."""
    srcs = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for p in srcs:
        for ln, line in enumerate(p.read_text().splitlines(), 1):
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            words = s.replace(",", " ").split()
            names = words[1:2] if s.startswith("from ") else words[1:]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "classpro_tpu"), \
                    f"{p.name}:{ln}: {s}"
