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
            "apex_tpu_torch.parallel, apex_tpu_torch.data, "
            "apex_tpu_torch.parallel.multiproc, "
            "apex_tpu_torch.parallel.distributed, "
            "apex_tpu_torch.examples.simple.distributed."
            "distributed_data_parallel, apex_tpu_torch.telemetry, "
            "apex_tpu_torch.prof.memory; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'apex_tpu', 'triton')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


#: test files that run as the workers of their own spawns
WORKER_TESTS = [os.path.join(REPO, "tests", name) for name in (
    "test_torch_distributed.py", "test_torch_syncbn_dist.py",
    "test_torch_telemetry.py")]


def _main_guard_line(tree):
    for node in tree.body:
        if isinstance(node, ast.If) and "__main__" in ast.dump(node.test):
            return node.lineno
    return None


@pytest.mark.parametrize("path", WORKER_TESTS,
                         ids=[os.path.basename(p) for p in WORKER_TESTS])
def test_worker_entry_points_import_no_jax(path):
    """A worker runs its file as ``__main__`` and exits inside the main
    guard, so every JAX or ``apex_tpu`` import must come after it (and
    none inside a function the worker calls: those import the port)."""
    tree = ast.parse(open(path).read(), path)
    guard = _main_guard_line(tree)
    assert guard is not None
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            roots = ([a.name.split(".")[0] for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module.split(".")[0]])
            if any(r in FORBIDDEN for r in roots):
                assert node.lineno > guard, (path, node.lineno)
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and (
                fn.name.startswith("_rank") or fn.name.startswith("_worker")
                or fn.name.startswith("_port")):
            bad = {r for node in ast.walk(fn)
                   if isinstance(node, ast.ImportFrom) and node.module
                   for r in [node.module.split(".")[0]] if r in FORBIDDEN}
            assert not bad, (path, fn.name, bad)
