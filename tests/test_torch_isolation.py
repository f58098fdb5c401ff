"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never drop to the CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "particlesmc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "particlesmc_tpu")


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "chip_ab.py")
    yield os.path.join(ROOT, "tests", "test_torch_spatial_gloo.py")
    yield os.path.join(ROOT, "tests", "test_torch_inputs.py")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import particlesmc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'particlesmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'particlesmc_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('particlesmc_tpu_torch.')]), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 15
    assert bad == "[]"


def test_new_subpackages_import_no_jax():
    """analysis/ and parallel/ load without JAX, and the spawned gloo ranks
    of tests/test_torch_spatial_gloo.py import no JAX either (that test
    checks each rank's modules)."""
    code = (
        "import sys\n"
        "import particlesmc_tpu_torch.analysis, particlesmc_tpu_torch.parallel.mesh\n"
        "import particlesmc_tpu_torch.parallel.spatial\n"
        "import tests.test_torch_spatial_gloo\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'particlesmc_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for sub in ("analysis", "parallel"):
        assert os.path.isfile(os.path.join(PKG, sub, "__init__.py"))


def test_sources_import_no_jax():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_entry_points_refuse_cpu_without_cuda(tmp_path):
    """Without CUDA, an entry point called with no device raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    from particlesmc_tpu_torch import cli
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.io.loader import load_chains
    from particlesmc_tpu_torch.models import tables
    from particlesmc_tpu_torch.moves import base
    from particlesmc_tpu_torch.runtime import resolve_device

    frame = os.path.join(ROOT, "examples", "movie", "inputframe.exyz")
    for call in (
        resolve_device,
        lambda: load_chains(frame, args={"temperature": 1.0, "model": "JBB"}),
        lambda: make_system([[0.0, 0.0], [1.0, 1.0]], [1, 2], 1.0, 1.0),
        tables.KobAndersen,
        lambda: base.init_pool_params((base.displacement(0.1),)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    params = os.path.join(ROOT, "examples", "movie", "params.toml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([params])
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
