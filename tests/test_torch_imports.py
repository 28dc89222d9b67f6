"""The port stands alone: ``apex_tpu_torch`` and ``chip_smoke.py`` import
no JAX, no flax and nothing of ``apex_tpu``, and importing the package on
a CPU host pulls in neither JAX nor Triton (kernels are built inside the
functions that launch them)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "apex_tpu")
SOURCES = sorted(glob.glob(os.path.join(REPO, "apex_tpu_torch", "**",
                                        "*.py"), recursive=True)) \
    + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) >= 15, SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_triton_out():
    code = ("import sys, apex_tpu_torch, apex_tpu_torch.serving, "
            "apex_tpu_torch.convert, apex_tpu_torch.serving.__main__, "
            "apex_tpu_torch.training, apex_tpu_torch.examples.lm.main_amp, "
            "apex_tpu_torch.examples.imagenet.main_amp, "
            "apex_tpu_torch.contrib.xentropy, apex_tpu_torch.contrib.groupbn, "
            "apex_tpu_torch.parallel, apex_tpu_torch.data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'apex_tpu', 'triton')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
