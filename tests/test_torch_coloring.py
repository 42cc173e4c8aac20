"""Matrix coloring parity of the PyTorch port with the JAX package (CPU).

``amgx_tpu_torch/ops/coloring.py`` is a copy of the JAX package's
numpy module: for every scheme name of ``_SCHEME_ALIASES``, with
``determinism_flag`` 0 and 1 and the config's coloring knobs, both
packages must give the same colours (``np.array_equal``) on the 16^3
Poisson matrix and on a seeded random symmetric sparse matrix, and
``validate_coloring`` must accept them.  ROUND_ROBIN is the reference's
calibration scheme (``i % num_colors``, no conflict resolution): it is
valid on the Poisson matrix and on the random one only where the two
packages agree it is.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.ops import coloring as jcol
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.ops import coloring as tcol

amgx_tpu.initialize()

SCHEMES = sorted(jcol._SCHEME_ALIASES)


def _random_symmetric(n=600, density=0.01, seed=7):
    """Seeded random symmetric pattern with a dominant diagonal."""
    rng = np.random.default_rng(seed)
    m = sps.random(n, n, density=density, random_state=rng,
                   data_rvs=lambda k: rng.uniform(-1.0, 0.0, k))
    m = (m + m.T).tocsr()
    m = m + sps.diags(np.asarray(abs(m).sum(axis=1)).ravel() + 1.0)
    m = m.tocsr()
    m.sort_indices()
    return m


_MATRICES = {
    "poisson16": lambda: poisson_scipy((16, 16, 16)).tocsr(),
    "random600": _random_symmetric,
}


def _cfg(scheme, det):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "MULTICOLOR_DILU",'
        f' "matrix_coloring_scheme": "{scheme}",'
        f' "determinism_flag": {det}}}}}'
    )


def test_scheme_table_is_the_jax_packages():
    assert tcol._SCHEME_ALIASES == jcol._SCHEME_ALIASES
    assert tcol._UNIFORM_MAX_COLORS == jcol._UNIFORM_MAX_COLORS


@pytest.mark.parametrize("det", [0, 1])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mat", sorted(_MATRICES))
def test_color_matrix_matches_jax(mat, scheme, det):
    m = _MATRICES[mat]()
    text = _cfg(scheme, det)
    jc = jcol.color_matrix(JMatrix.from_scipy(m), scheme, bool(det),
                           cfg=JConfig.from_string(text), scope="main")
    tc = tcol.color_matrix(TMatrix.from_scipy(m, device="cpu"), scheme,
                           bool(det), cfg=T.AMGConfig.from_string(text),
                           scope="main")
    assert tc.dtype == np.int32
    assert np.array_equal(tc, jc)
    valid = tcol.validate_coloring(m.indptr, m.indices, tc)
    assert valid == jcol.validate_coloring(m.indptr, m.indices, jc)
    if not (scheme == "ROUND_ROBIN" and mat == "random600"):
        assert valid


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("mat", sorted(_MATRICES))
def test_color_matrix_without_config_matches_jax(mat, det):
    """No config: the module's own defaults (8 hashes, no early exit)."""
    m = _MATRICES[mat]()
    for scheme in SCHEMES:
        jc = jcol.color_matrix(JMatrix.from_scipy(m), scheme, det)
        tc = tcol.color_matrix(TMatrix.from_scipy(m, device="cpu"),
                               scheme, det)
        assert np.array_equal(tc, jc), scheme


@pytest.mark.parametrize("level", [0, 2])
def test_coloring_level_matches_jax(level):
    m = _MATRICES["poisson16"]()
    text = _cfg("MIN_MAX", 0).replace(
        '"determinism_flag": 0', f'"determinism_flag": 0,'
        f' "coloring_level": {level}')
    jc = jcol.color_matrix(JMatrix.from_scipy(m), "MIN_MAX", False,
                           cfg=JConfig.from_string(text), scope="main")
    tc = tcol.color_matrix(TMatrix.from_scipy(m, device="cpu"), "MIN_MAX",
                           False, cfg=T.AMGConfig.from_string(text),
                           scope="main")
    assert np.array_equal(tc, jc)
    if level == 0:
        assert tc.max() == 0
    else:
        # distance-2: no two rows within two hops share a colour
        ip2, ix2 = tcol._two_ring_graph(m.indptr, m.indices, m.shape[0])
        assert tcol.validate_coloring(ip2, ix2, tc)


def test_print_coloring_info(capsys):
    m = _MATRICES["poisson16"]()
    text = _cfg("MIN_MAX", 0).replace(
        '"determinism_flag": 0', '"determinism_flag": 0,'
        ' "print_coloring_info": 1')
    tc = tcol.color_matrix(TMatrix.from_scipy(m, device="cpu"), "MIN_MAX",
                           False, cfg=T.AMGConfig.from_string(text),
                           scope="main")
    out = capsys.readouterr().out
    assert f"{int(tc.max()) + 1} colors over {m.shape[0]} rows" in out
    assert "valid=True" in out
