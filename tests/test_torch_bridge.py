"""The port's bridge server (tpufoam_torch/bridge/server.py) on the CPU:
its per-case compute against the JAX package's, and the unchanged C
clients of the repo's `bridge/` driving it over the wire (built with g++
as tests/test_bridge.py builds them; those tests skip without g++).

The case is demo_solver.cpp's: a 24 x 96 channel on [0, 4] x [0, 1] with
a cylinder of radius 0.15, 360 boundary points each, served at delta
0.05 (a 19 x 79 grid: the cells' extents rounded to 2 decimals).
Tolerances, max |port - JAX| / max |JAX| over the cells:
- identity: exact.
- poisson: 1e-4 (both solve MGCG to rtol 1e-6 from the same resampled
  fields; the solution is fixed to that residual times the operator's
  condition; measured 4.6e-6).
- sm (a tiny random deltaU_deltaP bundle, 16-blocks, lstsq): 1e-2,
  tests/test_torch_surrogate.py's bound for the bf16 MLP (an input that
  differs in its last float32 bit between the frameworks rounds to
  neighbouring bf16 values, 2^-8 apart; measured 1.7e-3).
- a multi-rank world against a single-rank session over the same cells:
  bit for bit (the same assembled cloud, one model run).
"""

import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.bridge import server as jserver
from tpufoam_torch.bridge import client as tclient
from tpufoam_torch.bridge import server as tserver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA = 0.05
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def demo_case():
    """demo_solver.cpp's cells [Ux, Uy, Cx, Cy, p], outline and cylinder."""
    ny, nx, lx, ly = 24, 96, 4.0, 1.0
    cx, cy, r = 1.0, 0.5, 0.15
    x = (np.arange(nx) + 0.5) * (lx / nx)
    y = (np.arange(ny) + 0.5) * (ly / ny)
    X, Y = np.meshgrid(x, y)
    X, Y = X.ravel(), Y.ravel()
    keep = (X - cx) ** 2 + (Y - cy) ** 2 >= r * r
    X, Y = X[keep], Y[keep]
    cells = np.stack([6.0 * (Y / ly) * (1 - Y / ly), np.zeros_like(X), X, Y,
                      np.zeros_like(X)], axis=-1)
    nb = 360
    per = 2.0 * (lx + ly)
    s = np.arange(nb) / nb * per
    top = np.where((s < lx)[:, None], np.stack([s, 0 * s], -1),
                   np.where((s < lx + ly)[:, None],
                            np.stack([0 * s + lx, s - lx], -1),
                            np.where((s < 2 * lx + ly)[:, None],
                                     np.stack([2 * lx + ly - s, 0 * s + ly],
                                              -1),
                                     np.stack([0 * s, per - s], -1))))
    th = 2.0 * np.pi * np.arange(nb) / nb
    obst = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=-1)
    return cells, top, obst


def perturbed(cells, step):
    """demo_solver.cpp's toy momentum predictor, one step."""
    c = cells.copy()
    x, y = c[:, 2], c[:, 3]
    c[:, 0] += 0.01 * np.sin(2.0 * x + 0.3 * step) * y * (1.0 - y)
    c[:, 1] += 0.01 * np.cos(3.0 * y + 0.2 * step)
    return c


@pytest.fixture(scope="module")
def sm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sm") / "bundle")
    _tiny_bundle(block_size=16).save(d)
    return d


def _model(name, sm_dir):
    return f"sm:{sm_dir}" if name == "sm" else name


@pytest.mark.parametrize("name,tol", [("identity", 0.0), ("poisson", 1e-4),
                                      ("sm", 1e-2)])
def test_compute_matches_jax(name, tol, sm_dir):
    cells, top, obst = demo_case()
    model = _model(name, sm_dir)
    jc = jserver._Compute(model, DELTA, 8e-3)
    tc = tserver._Compute(model, DELTA, 8e-3, device="cpu")
    jc.prepare(cells, top, obst)
    tc.prepare(cells, top, obst)
    if name != "identity":
        assert tc.ucase.case.grid.shape == jc.ucase.case.grid.shape \
            == (19, 79)
    c = cells
    for step in range(3):
        c = perturbed(c, step)
        pj, rj = jc.step(c)
        pt, rt = tc.step(c)
        for got, ref in ((pt, pj), (rt, rj)):
            assert got.shape == ref.shape == (len(cells),)
            assert np.isfinite(got).all()
            err = float(np.abs(got - ref).max())
            assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
                (step, err)
        if name != "identity":
            assert np.ptp(pt) > 0
            # the near-wall guard keeps the incoming p on cells within
            # 0.05 of a wall
            guard = tc.sdf_cells < 0.05
            assert guard.any() and (pt[guard] == c[guard, 4]).all()
        c = c.copy()
        c[:, 4] = pt


def _run_server(sock, model, delta=DELTA):
    srv = tserver.BridgeServer(str(sock), model=model, delta=delta,
                               device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    return srv, th


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no C++ toolchain")
    d = str(tmp_path_factory.mktemp("bridge_build"))
    lib = tclient.build_library(d, targets=("libtpufoam_bridge.so",
                                            "demo_solver",
                                            "rank_demo_solver"))
    return d, tclient.load_library(lib)


@needs_gxx
@pytest.mark.parametrize("name", ["identity", "poisson", "sm"])
def test_demo_solver_round_trip(built, tmp_path, name, sm_dir):
    d, _ = built
    sock = tmp_path / "tb.sock"
    srv, th = _run_server(sock, _model(name, sm_dir))
    try:
        out = subprocess.run([os.path.join(d, "demo_solver"), str(sock),
                              "3"], capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "bridge ready" in out.stdout and "demo done" in out.stdout
        assert out.stdout.count("DL pressure prediction") == 3
        ranges = re.findall(r"p in \[([-\d.eg+na]+), ([-\d.eg+na]+)\]",
                            out.stdout)
        lo, hi = map(float, ranges[-1])
        assert np.isfinite([lo, hi]).all()
        if name != "identity":
            assert hi > lo
        assert len(srv.step_ms) == 3
    finally:
        srv.stop()
        th.join(timeout=5)


@needs_gxx
def test_rank_demo_solver_worlds_match_single_rank(built, tmp_path):
    """The forked ranks of rank_demo_solver: 2 ranks with the identity
    model return each rank its own p; 2 ranks of poisson equal 1."""
    d, _ = built
    sock = tmp_path / "tbr.sock"
    srv, th = _run_server(sock, "identity")
    try:
        out = subprocess.run([os.path.join(d, "rank_demo_solver"),
                              str(sock), "2", "3"], capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "world done" in out.stdout
        assert "rank 0/2 ready" in out.stdout and "rank 1/2 ready" in \
            out.stdout
    finally:
        srv.stop()
        th.join(timeout=5)
    sock = tmp_path / "tbr2.sock"
    srv, th = _run_server(sock, "poisson")
    try:
        for n_ranks, world in (("1", "10"), ("2", "20")):
            out = subprocess.run(
                [os.path.join(d, "rank_demo_solver"), str(sock), n_ranks,
                 "2", str(tmp_path / f"w{world}"), world],
                capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, out.stdout + out.stderr
        p1 = np.fromfile(tmp_path / "w10.r0.bin")
        p2 = np.concatenate([np.fromfile(tmp_path / "w20.r0.bin"),
                             np.fromfile(tmp_path / "w20.r1.bin")])
        assert np.isfinite(p1).all() and p1.std() > 0
        np.testing.assert_array_equal(p1, p2)
    finally:
        srv.stop()
        th.join(timeout=5)


def _world(lib, sock, cells, top, obst, steps, n_ranks, world_id):
    """n_ranks client threads with contiguous slices of each step's cells
    (`cells[s]`); the concatenated p of each step."""
    n = len(cells[0])
    cuts = [k * n // n_ranks for k in range(n_ranks + 1)]
    out = [[None] * steps for _ in range(n_ranks)]
    errors = []

    def rank(k):
        try:
            lo, hi = cuts[k], cuts[k + 1]
            cl = tclient.Client(lib, str(sock), cells[0][lo:hi], top, obst,
                                rank=k, n_ranks=n_ranks, world_id=world_id)
            for s in range(steps):
                out[k][s] = cl.step(cells[s][lo:hi])[0]
            cl.close()
        except Exception as e:      # surfaced by the caller
            errors.append(e)

    ths = [threading.Thread(target=rank, args=(k,)) for k in range(n_ranks)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    assert not errors, errors
    return [np.concatenate([out[k][s] for k in range(n_ranks)])
            for s in range(steps)]


@needs_gxx
@pytest.mark.parametrize("name", ["poisson", "sm"])
def test_ctypes_world_of_four_equals_single_rank(built, tmp_path, name,
                                                 sm_dir):
    """The C API through ctypes: a 4-rank world (tb_init_rank, one thread
    a rank) against a single-rank session (tb_init), same cells."""
    _, lib = built
    cells, top, obst = demo_case()
    steps = [perturbed(cells, s) for s in range(2)]
    sock = tmp_path / "tbc.sock"
    srv, th = _run_server(sock, _model(name, sm_dir))
    try:
        cl = tclient.Client(lib, str(sock), steps[0], top, obst)
        single = []
        for c in steps:
            p, raw = cl.step(c)
            single.append(p)
            assert cl.last_step_ms > 0 and np.isfinite(raw).all()
        cl.close()
        multi = _world(lib, sock, steps, top, obst, 2, 4, world_id=3)
        for s, (a, b) in enumerate(zip(single, multi)):
            assert np.isfinite(a).all() and np.ptp(a) > 0
            np.testing.assert_array_equal(a, b, err_msg=f"step {s}")
    finally:
        srv.stop()
        th.join(timeout=5)


@needs_gxx
def test_world_barrier_under_thread_stress(built, tmp_path):
    """More ranks than cores, each a thread, with a short switch interval:
    every rank gets its own slice of each step's p back (the identity
    model, with p distinct per step and cell, so a slice of another rank
    or another round would show)."""
    _, lib = built
    cells, top, obst = demo_case()
    steps = []
    for s in range(3):
        c = perturbed(cells, s)
        c[:, 4] = s * 1e6 + np.arange(len(c))
        steps.append(c)
    sock = tmp_path / "tbs.sock"
    srv, th = _run_server(sock, "identity")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _world(lib, sock, steps, top, obst, 3,
                     (os.cpu_count() or 4) + 4, world_id=11)
        for s, (g, c) in enumerate(zip(got, steps)):
            np.testing.assert_array_equal(g, c[:, 4], err_msg=f"step {s}")
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
        th.join(timeout=5)
    assert not th.is_alive()


@needs_gxx
def test_client_refuses_cells_of_the_wrong_shape(built, tmp_path):
    _, lib = built
    cells, top, obst = demo_case()
    sock = tmp_path / "tbv.sock"
    srv, th = _run_server(sock, "identity")
    try:
        with pytest.raises(ValueError, match="cells"):
            tclient.Client(lib, str(sock), cells[:, :4], top, obst)
        cl = tclient.Client(lib, str(sock), cells, top, obst)
        with pytest.raises(ValueError, match="cells"):
            cl.step(cells[:-1])
        cl.close()
    finally:
        srv.stop()
        th.join(timeout=5)


@needs_gxx
def test_world_releases_its_ranks_when_one_leaves(built, tmp_path):
    """A rank that closes while another waits at the step barrier fails
    the world: the waiting rank's step returns an error (no hang), and a
    new world with the same id starts afresh once all have left."""
    _, lib = built
    cells, top, obst = demo_case()
    half = len(cells) // 2
    sock = tmp_path / "tbw.sock"
    srv, th = _run_server(sock, "identity")
    try:
        clients = [None, None]

        def join(k):
            lo, hi = (0, half) if k == 0 else (half, len(cells))
            clients[k] = tclient.Client(lib, str(sock), cells[lo:hi], top,
                                        obst, rank=k, n_ranks=2,
                                        world_id=9)

        ths = [threading.Thread(target=join, args=(k,)) for k in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        failed = []

        def step0():
            try:
                clients[0].step(cells[:half])
            except RuntimeError as e:
                failed.append(e)

        waiter = threading.Thread(target=step0)
        waiter.start()
        time.sleep(0.5)             # rank 0 waits at the barrier
        clients[1].close()
        waiter.join(timeout=30)
        assert not waiter.is_alive() and len(failed) == 1
        clients[0].close()
        deadline = time.time() + 10
        while 9 in srv._worlds and time.time() < deadline:
            time.sleep(0.05)
        assert 9 not in srv._worlds
        # the same world id serves a new world
        got = _world(lib, sock, [cells], top, obst, 1, 2, world_id=9)
        np.testing.assert_array_equal(got[0], cells[:, 4])
    finally:
        srv.stop()
        th.join(timeout=5)


@needs_gxx
def test_server_command_line_on_the_cpu(built, tmp_path):
    """`python -m tpufoam_torch.bridge.server <sock> identity --device
    cpu` serves demo_solver."""
    d, _ = built
    sock = tmp_path / "tbcli.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpufoam_torch.bridge.server", str(sock),
         "identity", "--delta", str(DELTA), "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while not os.path.exists(sock) and time.time() < deadline:
            time.sleep(0.1)
        out = subprocess.run([os.path.join(d, "demo_solver"), str(sock),
                              "2"], capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.count("DL pressure prediction") == 2
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
