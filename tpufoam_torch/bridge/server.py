"""The serving process for external CFD solvers, on the card.

The Python side of the C bridge (bridge/tpufoam_bridge.{h,cpp}), with the
JAX package's wire protocol, so the same C client drives either server:

  init  map the client's shared-memory arena; build the uniform grid,
        the resampling both ways, the SDF and the masks, once per case
        (eval.evaluation.UnstructuredCase.from_frame).
  step  read [Ux, Uy, Cx, Cy, p] from the arena, resample onto the grid,
        run the pressure model on the device, resample back to the
        solver's cells, keep the old p where the SDF is below 0.05 (the
        near-wall guard) or the model's value is not finite, and write p
        and the model's raw output into the arena.

Two client modes:
  single-rank (TBI1): one connection carries the whole case (the
  reference's gather to rank 0).
  multi-rank (TBI2, `tb_init_rank`): each solver rank connects with its
  own cells; the server barriers the ranks each step, assembles the cloud
  in rank order, runs the model once, and writes each rank's slice into
  its own arena.

Pressure models: 'identity' (p returned unchanged), 'poisson' (MGCG at
rtol 1e-6 on the pressure equation of the current velocity) and
'sm:<bundle_dir>' (a SurrogateBundle, least-squares stitch).

Every tensor of a case lives on the server's device; connection threads
may run device work at once (each kernel launcher launches on its
operand's card).

    python -m tpufoam_torch.bridge.server <socket> [model] --delta D \\
        --nu NU --device {cuda,cpu}
"""

from __future__ import annotations

import collections
import mmap
import os
import socket
import struct
import threading
import time
import traceback

import numpy as np
import torch

from .. import DEFAULT_DEVICE

_INIT = struct.Struct("<4sQQQ108s")          # TBI1 (magic included)
_INIT2 = struct.Struct("<4sQQQiii108s")      # TBI2: + rank, n_ranks, world
_STATUS_OK = struct.pack("<I", 0)
_STATUS_ERR = struct.pack("<I", 1)
_WORLD_TIMEOUT_S = 120.0


class _Compute:
    """A case's model state and step, wherever its cells live (one arena,
    or the concatenation of a world's arenas)."""

    def __init__(self, model, delta: float, nu: float,
                 device=DEFAULT_DEVICE):
        self.model = model
        self.delta = delta
        self.nu = nu
        self.device = torch.device(device)
        self.state = None

    def prepare(self, cells: np.ndarray, top: np.ndarray, obst: np.ndarray):
        """The one-time mesh prep."""
        if self.model == "identity":
            return
        from ..eval.evaluation import UnstructuredCase
        from ..utils.hdf5_io import SimFrame

        fr = SimFrame(
            data=np.ascontiguousarray(
                cells[:, [0, 1, 4, 2, 3]]).astype(np.float32),
            top=top.astype(np.float32),
            obst=obst.astype(np.float32),
            channels=("Ux", "Uy", "p", "Cx", "Cy"),
        )
        self.attach(UnstructuredCase.from_frame(fr, self.delta, self.nu,
                                                device=self.device))

    def attach(self, ucase):
        """Take a prepared mesh (an UnstructuredCase on this compute's
        device) and set up the model's state on it."""
        self.ucase = ucase
        case = ucase.case
        self.p_prev_grid = torch.zeros(case.grid.shape, device=self.device)
        # the SDF at the solver's cells, for the near-wall guard
        self.sdf_cells = self.ucase.resample_back(
            case.sdf.reshape(-1)).cpu().numpy()

        if isinstance(self.model, str) and self.model.startswith("sm:"):
            from ..surrogate.pipeline import SurrogateBundle, make_predictor
            bundle = SurrogateBundle.load(self.model[3:], device=self.device)
            # the stitch operator resolved once, for this case
            self.predictor = make_predictor(bundle, stitch="lstsq").bind(case)

    def step(self, cells: np.ndarray):
        """cells (n, 5) -> (p_cells, raw model output), both (n,)."""
        if self.model == "identity":
            p = np.ascontiguousarray(cells[:, 4])
            return p, p

        uc = self.ucase
        case = uc.case
        u = uc.grid_field(cells[:, 0].astype(np.float32))
        v = uc.grid_field(cells[:, 1].astype(np.float32))
        p = uc.grid_field(cells[:, 4].astype(np.float32))

        with torch.no_grad():
            if self.model == "poisson":
                p_new = self._poisson_pressure(case, u, v, p)
            else:
                aux = dict(u=u, v=v, p=p,
                           u_prev=self.u_prev if self.state else u,
                           v_prev=self.v_prev if self.state else v,
                           p_prev=self.p_prev_grid)
                p_new = self.predictor(case, self.p_prev_grid, aux)
        self.u_prev, self.v_prev = u, v
        self.p_prev_grid = p_new
        self.state = True

        # grid -> solver cells, near-wall guard + non-finite fallback
        p_cells = uc.resample_back(p_new.reshape(-1)).cpu().numpy()
        raw = np.nan_to_num(p_cells)
        p_old = cells[:, 4]
        p_cells = np.where(self.sdf_cells < 0.05, p_old, p_cells)
        p_cells = np.where(np.isfinite(p_cells), p_cells, p_old)
        return p_cells, raw

    def _poisson_pressure(self, case, u, v, p):
        """The pressure Poisson solve from the current velocity: MGCG on
        the pressure equation with unit rAU and the fluxes of (u, v)."""
        from ..fv.case import fluxes_from_velocity
        from ..fv.pressure import pressure_coeffs, pressure_rhs
        from ..solvers.multigrid import mgcg_pressure

        phi_x, phi_y = fluxes_from_velocity(case, u, v)
        rau = torch.ones(case.grid.shape, device=u.device) * case.fluid
        coef = pressure_coeffs(case, rau)
        rhs = pressure_rhs(case, phi_x, phi_y)
        return mgcg_pressure(coef, rhs, x0=p, rtol=1e-6).x * case.fluid


class _Arena:
    """A client's shared-memory mapping: views into its field regions."""

    def __init__(self, n_cells: int, n_top: int, n_obst: int, shm_path: str):
        self.n_cells, self.n_top, self.n_obst = n_cells, n_top, n_obst
        fd = os.open(f"/dev/shm{shm_path}", os.O_RDWR)
        total = 8 * (n_cells * 5 + n_top * 2 + n_obst * 2 + 2 * n_cells)
        self.mm = mmap.mmap(fd, total)
        os.close(fd)
        buf = np.frombuffer(self.mm, dtype=np.float64)
        o1 = n_cells * 5
        o2 = o1 + n_top * 2
        o3 = o2 + n_obst * 2
        o4 = o3 + n_cells
        self.cells = buf[:o1].reshape(n_cells, 5)
        self.top = buf[o1:o2].reshape(n_top, 2)
        self.obst = buf[o2:o3].reshape(n_obst, 2)
        self.p_out = buf[o3:o4]
        # the model's raw output before the guards (the reference's `out`)
        self.sm_out = buf[o4:]

    def close(self):
        # drop the views first: mmap.close() raises BufferError while
        # exported buffers are alive
        self.cells = self.top = self.obst = self.p_out = self.sm_out = None
        try:
            self.mm.close()
        except BufferError:
            pass  # a view escaped; the mapping goes with its last view


class _Session:
    """A single-rank session: one arena and its own compute."""

    def __init__(self, n_cells: int, n_top: int, n_obst: int, shm_path: str,
                 model, delta: float, nu: float, device=DEFAULT_DEVICE):
        self.arena = _Arena(n_cells, n_top, n_obst, shm_path)
        self.compute = _Compute(model, delta, nu, device)
        self.compute.prepare(self.arena.cells, self.arena.top,
                             self.arena.obst)

    def step(self):
        p, raw = self.compute.step(self.arena.cells)
        self.arena.sm_out[:] = raw
        self.arena.p_out[:] = p

    def close(self):
        self.arena.close()


class _World:
    """A multi-rank case: a barrier each step, then gather, compute and
    scatter.

    The last rank to arrive at a barrier does the global work while the
    others wait on the condition: concatenate the ranks' cells in rank
    order, run the model once, write each rank's slice into its arena.
    So a world equals a single-rank session over the concatenated cells.
    A world error (an init failure, a barrier timeout, a rank that
    leaves mid-step) fails every rank for good; a compute error fails
    that step for every rank, and the next step may succeed."""

    def __init__(self, world_id: int, n_ranks: int, model, delta, nu,
                 device=DEFAULT_DEVICE):
        self.world_id = world_id
        self.n_ranks = n_ranks
        self.compute = _Compute(model, delta, nu, device)
        self.cond = threading.Condition()
        self.arenas: dict[int, _Arena] = {}
        self.ready = False
        self.error: Exception | None = None
        self.step_error: Exception | None = None
        self.step_no = 0
        self.arrived = 0
        self.left = 0

    def _fail(self, e: Exception):
        self.error = e
        self.cond.notify_all()

    def _cells(self) -> np.ndarray:
        return np.concatenate([self.arenas[r].cells
                               for r in range(self.n_ranks)])

    def join(self, rank: int, arena: _Arena):
        """Register a rank; the last one runs the mesh prep. Returns after
        the prep, or raises on a world error."""
        with self.cond:
            if rank in self.arenas or not (0 <= rank < self.n_ranks):
                raise ValueError(f"bad rank {rank}/{self.n_ranks}")
            self.arenas[rank] = arena
            if len(self.arenas) == self.n_ranks:
                try:
                    a0 = self.arenas[0]
                    self.compute.prepare(self._cells(), a0.top, a0.obst)
                    self.ready = True
                    self.cond.notify_all()
                except Exception as e:
                    self._fail(e)
            else:
                deadline = time.monotonic() + _WORLD_TIMEOUT_S
                while not self.ready and self.error is None:
                    if (not self.cond.wait(timeout=1.0)
                            and time.monotonic() > deadline):
                        self._fail(TimeoutError(
                            f"world {self.world_id}: "
                            f"{len(self.arenas)}/{self.n_ranks} ranks"))
            if self.error is not None:
                raise RuntimeError(f"world init failed: {self.error}")

    def step(self, rank: int):
        with self.cond:
            my_step = self.step_no
            self.arrived += 1
            if self.arrived == self.n_ranks:
                self.arrived = 0
                try:
                    p, raw = self.compute.step(self._cells())
                    off = 0
                    for r in range(self.n_ranks):
                        a = self.arenas[r]
                        a.p_out[:] = p[off:off + a.n_cells]
                        a.sm_out[:] = raw[off:off + a.n_cells]
                        off += a.n_cells
                    self.step_error = None
                except Exception as e:
                    self.step_error = e
                self.step_no += 1
                self.cond.notify_all()
            else:
                deadline = time.monotonic() + _WORLD_TIMEOUT_S
                while self.step_no == my_step and self.error is None:
                    if (not self.cond.wait(timeout=1.0)
                            and time.monotonic() > deadline):
                        self._fail(TimeoutError(
                            f"world {self.world_id}: step barrier"))
            # step_error cannot be overwritten here: the next round ends
            # only after every rank, this one included, has returned
            if self.error is not None:
                raise RuntimeError(f"world step failed: {self.error}")
            if self.step_error is not None:
                raise RuntimeError(f"world step failed: {self.step_error}")

    def leave(self, rank: int) -> bool:
        """Close a rank's arena and wake the barrier's waiters (a departed
        rank can never complete it). True when the world is empty."""
        with self.cond:
            a = self.arenas.pop(rank, None)
            if a is not None:
                a.close()
            self.left += 1
            if self.arenas and self.arrived > 0:
                self._fail(ConnectionError(f"rank {rank} left mid-step"))
            return self.left >= self.n_ranks


class BridgeServer:
    """One thread per connection: single-rank (TBI1) sessions are
    independent, multi-rank (TBI2) connections meet in a _World. Every
    case's tensors live on `device`. `step_ms` holds the server's own wall
    time of each of the last 1024 steps it served."""

    def __init__(self, socket_path: str, model: str = "identity",
                 delta: float = 0.02, nu: float = 8e-3,
                 device=DEFAULT_DEVICE):
        self.socket_path = socket_path
        self.model = model
        self.delta = delta
        self.nu = nu
        self.device = torch.device(device)
        self.step_ms = collections.deque(maxlen=1024)
        self._stop = threading.Event()
        self._worlds: dict[int, _World] = {}
        self._worlds_lock = threading.Lock()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(socket_path)
        self.sock.listen(16)
        self.sock.settimeout(0.5)

    def serve_forever(self):
        threads = []
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            th = threading.Thread(target=self._dispatch, args=(conn,),
                                  daemon=True)
            th.start()
            threads = [t for t in threads if t.is_alive()]
            threads.append(th)
        for th in threads:
            th.join(timeout=2.0)
        self.sock.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def stop(self):
        self._stop.set()

    def _recv_all(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def _dispatch(self, conn):
        try:
            magic = self._recv_all(conn, 4)
            if magic == b"TBI1":
                self._handle_single(conn, magic)
            elif magic == b"TBI2":
                self._handle_rank(conn, magic)
            else:
                conn.sendall(_STATUS_ERR)
        except ConnectionError:
            pass
        finally:
            conn.close()

    def _step_loop(self, conn, do_step):
        """The STEP/BYE loop; `do_step()` raises on failure."""
        while True:
            magic = self._recv_all(conn, 4)
            if magic == b"TBX1":
                return
            if magic != b"TBS1":
                conn.sendall(_STATUS_ERR)
                return
            try:
                t0 = time.perf_counter()
                do_step()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                conn.sendall(_STATUS_OK)
            except Exception:
                print("bridge step failed:", flush=True)
                traceback.print_exc()
                conn.sendall(_STATUS_ERR)

    def _handle_single(self, conn, magic):
        raw = magic + self._recv_all(conn, _INIT.size - 4)
        _, n_cells, n_top, n_obst, shm = _INIT.unpack(raw)
        shm_path = shm.split(b"\0")[0].decode()
        try:
            sess = _Session(n_cells, n_top, n_obst, shm_path, self.model,
                            self.delta, self.nu, self.device)
            conn.sendall(_STATUS_OK)
        except Exception:
            print("bridge init failed:", flush=True)
            traceback.print_exc()
            conn.sendall(_STATUS_ERR)
            return
        try:
            self._step_loop(conn, sess.step)
        finally:
            sess.close()

    def _handle_rank(self, conn, magic):
        raw = magic + self._recv_all(conn, _INIT2.size - 4)
        _, n_cells, n_top, n_obst, rank, n_ranks, world_id, shm = \
            _INIT2.unpack(raw)
        shm_path = shm.split(b"\0")[0].decode()
        world = None
        arena = None
        try:
            with self._worlds_lock:
                world = self._worlds.get(world_id)
                if world is None:
                    world = _World(world_id, n_ranks, self.model,
                                   self.delta, self.nu, self.device)
                    self._worlds[world_id] = world
                elif world.n_ranks != n_ranks:
                    raise ValueError(
                        f"world {world_id}: n_ranks mismatch "
                        f"({n_ranks} vs {world.n_ranks})")
            arena = _Arena(n_cells, n_top, n_obst, shm_path)
            world.join(rank, arena)
            conn.sendall(_STATUS_OK)
        except Exception:
            print("bridge rank init failed:", flush=True)
            traceback.print_exc()
            try:
                conn.sendall(_STATUS_ERR)
            except OSError:
                pass
            if world is not None:
                # a rank refused before its arena was registered is not
                # found by leave(): close its mapping here
                if arena is not None and world.arenas.get(rank) is not arena:
                    arena.close()
                self._reap(world, rank)
            return
        try:
            self._step_loop(conn, lambda: world.step(rank))
        finally:
            self._reap(world, rank)

    def _reap(self, world: _World, rank: int):
        if world.leave(rank):
            with self._worlds_lock:
                if self._worlds.get(world.world_id) is world:
                    del self._worlds[world.world_id]


def serve(socket_path: str, model: str = "identity", delta: float = 0.02,
          nu: float = 8e-3, device=DEFAULT_DEVICE):
    """Serve until interrupted."""
    BridgeServer(socket_path, model, delta, nu, device).serve_forever()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("socket_path")
    ap.add_argument("model", nargs="?", default="identity",
                    help="identity | poisson | sm:<bundle_dir>")
    ap.add_argument("--delta", type=float, default=0.02)
    ap.add_argument("--nu", type=float, default=8e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    serve(args.socket_path, args.model, args.delta, args.nu, args.device)
