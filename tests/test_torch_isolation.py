"""The port stands alone: importing every module of dryad_tpu_torch pulls
in neither jax nor dryad_tpu (checked in a fresh interpreter and by an
import scan of the source), and its entry points default to the CUDA
card — refusing, not falling back to the CPU, where there is none."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import dryad_tpu_torch
from dryad_tpu_torch.parallel.mesh import resolve_device

PKG = pathlib.Path(dryad_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "dryad_tpu" or name.startswith("dryad_tpu."))


def test_import_leaves_jax_and_dryad_tpu_out():
    mods = _modules()
    assert "dryad_tpu_torch.ops.hopper_kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dryad_tpu' or "
            "m.startswith('dryad_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_dryad_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path}: imports {name}"


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryad_tpu_torch.Context()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert dryad_tpu_torch.Context(device="cpu").device.type == "cpu"
