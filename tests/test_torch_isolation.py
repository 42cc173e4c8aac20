"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless the caller asks
for the CPU — without a card they raise, never falling back silently.

The package's name starts with ``amgx_tpu``, so the checks match
``amgx_tpu`` only as a whole module name (``amgx_tpu`` or
``amgx_tpu.<sub>``), never the bare prefix.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amgx_tpu_torch as T
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import poisson_3d_7pt, poisson_scipy

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "amgx_tpu_torch"

_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|amgx_tpu)(?:\.|\s|,|$)",
    re.MULTILINE,
)


_CI_SCRIPTS = [ROOT / "ci" / "torch_port_compare.py",
               ROOT / "ci" / "torch_stencil_geometry.py",
               ROOT / "ci" / "torch_classical_compare.py",
               ROOT / "ci" / "torch_dia_compare.py",
               ROOT / "ci" / "torch_match_gate_compare.py"]


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", *_CI_SCRIPTS]
    assert len(files) > 20
    return files


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for f in _port_sources():
        for m in _FORBIDDEN_IMPORT.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad


_JAX_MODULE = re.compile(r"\bamgx_tpu\.[a-z]|\bjax\b", re.IGNORECASE)


def test_native_sources_embed_the_port_and_never_the_jax_package():
    """The C shim imports ``amgx_tpu_torch.api.capi`` and its sources and
    the C host program name no module of the JAX package, nor JAX."""
    native = sorted((PORT / "native").glob("*.[ch]"))
    assert {p.name for p in native} >= {"amgx_tpu_torch_c.c",
                                        "amgx_tpu_torch_c.h",
                                        "capi_poisson.c"}
    shim = (PORT / "native" / "amgx_tpu_torch_c.c").read_text()
    assert shim.count('PyImport_ImportModule("amgx_tpu_torch.api.capi")') \
        == 2
    assert "PyImport_ImportModule" not in shim.replace(
        'PyImport_ImportModule("amgx_tpu_torch.api.capi")', "")
    bad = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in native
           for m in _JAX_MODULE.finditer(p.read_text())]
    assert not bad, bad


def test_native_pattern_matches_the_jax_package_only():
    assert _JAX_MODULE.search('PyImport_ImportModule("amgx_tpu.api.capi")')
    assert _JAX_MODULE.search("/* JAX runtimes */")
    assert not _JAX_MODULE.search('"amgx_tpu_torch.api.capi"')
    assert not _JAX_MODULE.search("amgx_tpu/ops/pallas_dia.py:76")


def test_pattern_matches_whole_module_names_only():
    assert _FORBIDDEN_IMPORT.search("import amgx_tpu\n")
    assert _FORBIDDEN_IMPORT.search("from amgx_tpu.ops import spmv\n")
    assert _FORBIDDEN_IMPORT.search("    import jax.numpy as jnp\n")
    assert not _FORBIDDEN_IMPORT.search("import amgx_tpu_torch\n")
    assert not _FORBIDDEN_IMPORT.search("from amgx_tpu_torch.ops import x\n")


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, amgx_tpu_torch, amgx_tpu_torch.amg.aggregation\n"
        "import amgx_tpu_torch.amg.device_setup, amgx_tpu_torch.amg.energymin\n"
        "import amgx_tpu_torch.io.matrix_market, amgx_tpu_torch.ops.reorder\n"
        "import amgx_tpu_torch.ops.ff, amgx_tpu_torch.solvers.refinement\n"
        "import amgx_tpu_torch.amg.spgemm, amgx_tpu_torch.core.types\n"
        "import amgx_tpu_torch.api.capi, amgx_tpu_torch.ops.analysis\n"
        "import amgx_tpu_torch.core.printing, amgx_tpu_torch.version\n"
        "import amgx_tpu_torch.serve, amgx_tpu_torch.serve.service\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'amgx_tpu'\n"
        "             or m.startswith('amgx_tpu.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    m = poisson_scipy((4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poisson_3d_7pt(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseMatrix.from_scipy(m)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseMatrix.from_csr(m.indptr, m.indices, m.data)
    cfg = T.AMGConfig.from_string(
        '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION"}}}'
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.create_solver(cfg, "default")
    # asked for explicitly, the CPU works
    s = T.create_solver(cfg, "default", device="cpu")
    s.setup(poisson_3d_7pt(4, device="cpu"))
    assert s.solve(np.ones(64)).status == 0


def test_serve_sources_are_checked_and_import_neither_jax_nor_the_jax_package():
    serve = sorted((PORT / "serve").glob("*.py"))
    assert {p.name for p in serve} >= {"__init__.py", "bucketing.py",
                                       "cache.py", "batched.py",
                                       "metrics.py", "service.py"}
    assert set(serve) <= set(_port_sources())
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in serve
           for m in _FORBIDDEN_IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_serve_raises_without_cuda_and_runs_nothing_on_the_cpu(no_cuda):
    from amgx_tpu_torch.api import capi
    from amgx_tpu_torch.serve import BatchedSolveService, SolveService

    for make in (lambda: BatchedSolveService(),
                 lambda: SolveService(max_batch=4),
                 lambda: BatchedSolveService(device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # the C API's batched solve in a d mode: refused at the handle
    capi.initialize()
    cfg = capi.config_create(
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "PCG"}}')
    res = capi.resources_create_simple(cfg)
    with pytest.raises(capi.AMGXError) as e:
        capi.solver_create(res, "dDDI", cfg)
    assert e.value.rc == capi.RC_NOT_SUPPORTED_TARGET
    # asked for explicitly, the CPU serves
    m = poisson_scipy((4, 4))
    r = BatchedSolveService(device="cpu").solve_many([(m, np.ones(16))])
    assert r[0].status == 0 and r[0].x.device.type == "cpu"


def test_setup_rejects_a_matrix_on_another_device():
    cfg = T.AMGConfig.from_string(
        '{"config_version": 2, "solver": {"scope": "main", "solver": "CG"}}'
    )
    s = T.create_solver(cfg, "default", device="cpu")
    A = poisson_3d_7pt(3, device="cpu")
    A_meta = SparseMatrix(**{
        **A.__dict__, "values": A.values.to("meta"),
    })
    with pytest.raises(ValueError, match="meta"):
        s.setup(A_meta)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    in the repository and alone in an empty directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("script", _CI_SCRIPTS, ids=lambda p: p.stem)
def test_ci_script_fails_without_cuda(script):
    """The port's measurement scripts under ci/ exit non-zero and print
    nothing without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(script)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA is not available" in out.stderr
