"""The parts of ``chip_smoke.py`` that run on the CPU beside the card's
work: the CPU port's reference runs it starts in a child process
(``CpuSide``, ``cpu_side_calls``) and the stencil matrices its kernel
cases build (``stencil_scipy``).

A started run must give what the phase would get running it in line
(the same bits, given the same torch threads), every call must cross
to the child (module-level function, hashable key), and a run no one
started runs in line.
"""

import pickle

import numpy as np
import scipy.sparse as sps
import torch

import chip_smoke


def test_cpu_side_calls_cross_to_a_child():
    calls = chip_smoke.cpu_side_calls(chip_smoke.PHASES)
    assert len(calls) == len(set(calls))
    for call in calls:
        fn = call[0]
        assert getattr(chip_smoke, fn.__name__) is fn
        assert pickle.loads(pickle.dumps(call)) == call
    # every phase that holds the card to the CPU port starts its runs
    # (the fleet's workers are held to solves on the card)
    started = {p for p in chip_smoke.PHASES
               if chip_smoke.cpu_side_calls((p,))}
    assert started == set(chip_smoke.PHASES) - {"kernels", "mf_bf16",
                                                "setup_store", "fleet"}


def test_started_run_equals_the_run_in_line():
    call = (chip_smoke.cpu_solve, chip_smoke.BENCH_CFG, 10, np.float32)
    inline = chip_smoke.cpu_solve(*call[1:])
    side = chip_smoke.CpuSide()
    side.start([call], [torch.get_num_threads()])
    try:
        got = side.get(*call)
        assert not side.jobs
        assert side.wait_s >= 0.0
    finally:
        side.end()
    assert got["iterations"] == inline["iterations"]
    assert got["status"] == inline["status"] == 0
    assert got["x"].tobytes() == inline["x"].tobytes()
    assert got["levels"] == inline["levels"]
    # not started: runs here
    again = side.get(*call)
    assert again["x"].tobytes() == inline["x"].tobytes()


def _stencil_coo(grid, steps, coefs):
    nx, ny, nz = grid
    n = nx * ny * nz
    i = np.arange(n)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    rows, cols, vals = [], [], []
    for (dx, dy, dz), c in zip(steps, coefs):
        r = i[(ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
              & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz)]
        rows.append(r)
        cols.append(r + dx + nx * dy + nx * ny * dz)
        vals.append(np.full(r.shape[0], float(c)))
    A = sps.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                               np.concatenate(cols))),
                       shape=(n, n)).tocsr()
    A.sort_indices()
    return A


def test_stencil_scipy_matches_a_coo_build():
    box = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    nineteen = [st for st in box if sum(map(abs, st)) <= 2]
    wide = [(0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (2, 0, 0), (0, 0, 1)]
    for grid, steps in (((7, 5, 4), nineteen), ((9, 3, 2), wide),
                        ((5, 3, 40), nineteen)):
        coefs = np.random.default_rng(0).standard_normal(len(steps))
        got = chip_smoke.stencil_scipy(grid, steps, coefs)
        want = _stencil_coo(grid, steps, coefs)
        assert got.has_canonical_format
        assert np.array_equal(got.indptr, want.indptr)
        assert np.array_equal(got.indices, want.indices)
        assert np.array_equal(got.data, want.data)


def test_fleet_walk_mix_finds_the_groups_run():
    """The fleet phase holds each worker's launches to walks of the
    groups it ran: a mix of the fingerprints' walks with that many
    groups in all, or none."""
    dia, ell = "dia_spmv_batched_f64", "ell_spmv_batched_f64"
    w, w2 = {dia: 182, ell: 52}, {dia: 196, ell: 60}
    walks = {"a": w, "b": w, "c": w2}

    def launches(n, n2):
        return {dia: 182 * n + 196 * n2, ell: 52 * n + 60 * n2}

    assert chip_smoke.fleet_walk_mix(launches(30, 3), walks, 33) == {
        "a+b": 30, "c": 3}
    assert chip_smoke.fleet_walk_mix(launches(30, 3), walks, 34) is None
    assert chip_smoke.fleet_walk_mix(launches(16, 0), walks,
                                     range(1, 17)) == {"a+b": 16, "c": 0}
    assert chip_smoke.fleet_walk_mix(launches(16, 0), walks,
                                     range(1, 16)) is None
    off = {dia: 182 * 5 + 1, ell: 52 * 5}
    assert chip_smoke.fleet_walk_mix(off, walks, range(1, 17)) is None
    # an entry point no walk launches
    stray = {**launches(2, 0), "sell_spmv_batched_f64": 1}
    assert chip_smoke.fleet_walk_mix(stray, walks, 2) is None
    assert chip_smoke.fleet_walk_mix({}, walks, 0) == {"a+b": 0, "c": 0}
    assert chip_smoke.fleet_walk_mix(launches(4, 0), {"a": w, "b": w},
                                     4) == {"a+b": 4}
