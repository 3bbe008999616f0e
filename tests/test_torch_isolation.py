"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of classpro_tpu_torch (and
chip_smoke.py) and must end with no ``jax*``, no ``classpro_tpu`` /
``classpro_tpu.*`` and no repo-root ``tools`` / ``tools.*`` key (those
dev tools import the JAX package) in sys.modules.  Nor does the port
build a source from outside its package: every file and include
directory that native.py and kernels.py hand to a compiler lies under
classpro_tpu_torch/.
"""
import os
import pathlib
import re
import subprocess
import sys
import types

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
           "k.startswith(('classpro_tpu.', 'tools.')) or k == 'tools')",
           "print(bad)", "sys.exit(1 if bad else 0)"])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_package():
    """No source of the port (nor chip_smoke.py) mentions an import of
    jax, of classpro_tpu's modules or of the repo-root tools."""
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
                                               "classpro_tpu", "tools"), \
                    f"{p.name}:{ln}: {s}"


def _paths_in(cmd: list) -> list[pathlib.Path]:
    """The compiler command's arguments that name a file or directory
    (sources, include directories, outputs), resolved."""
    out = []
    for a in map(str, cmd):
        if a.startswith("-I") and len(a) > 2:
            a = a[2:]
        if os.path.isabs(a) or os.path.exists(a):
            out.append(pathlib.Path(os.path.realpath(a)))
    return out


def test_port_builds_only_its_own_sources(monkeypatch):
    """native.py's host library and every kernel library (CUDA and g++
    shim, with and without phase clocks) are compiled from sources under
    classpro_tpu_torch/ with only its include directories; the kernels'
    headers, and every header a source includes, are there too."""
    from classpro_tpu_torch import kernels, native

    cmds = []

    def run(cmd, **kw):
        cmds.append(("native", list(cmd)))
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native.os, "replace", lambda a, b: None)
    native._build()
    def compile_(cmd, so, key):
        cmds.append(("kernels", list(cmd)))
        kernels.BUILD_LOG[key] = ""

    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    monkeypatch.setattr(kernels, "_compile", compile_)
    for name in kernels.SOURCES:
        for kind in ("cuda", "host"):
            for clocks in (False, True):
                kernels.build(kind, name, force=True, clocks=clocks)
    assert len(cmds) == 1 + 4 * len(kernels.SOURCES)
    src = pathlib.Path(native._SRC).resolve()
    assert src == PKG / "csrc" / "host" / "classpro_host.cpp"
    assert any(src in _paths_in(c) for w, c in cmds if w == "native")
    built = set()
    for who, cmd in cmds:
        paths = _paths_in(cmd)
        assert paths, (who, cmd)
        for p in paths:
            assert PKG in p.parents, f"{who} builds from {p}: {cmd}"
        built.update(p for p in paths if p.suffix in (".cu", ".cpp"))
    assert built == {src} | {(PKG / "csrc" / s).resolve()
                             for s, _ in kernels.SOURCES.values()}
    hdrs = {h for _, hs in kernels.SOURCES.values() for h in hs}
    todo = list(built) + [PKG / "csrc" / h for h in hdrs]
    seen = set()
    while todo:
        f = todo.pop()
        assert f.is_file() and PKG in f.resolve().parents, f
        if f in seen:
            continue
        seen.add(f)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              f.read_text(), re.M):
            todo.append((f.parent / inc).resolve())
