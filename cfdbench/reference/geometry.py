"""Parametric 2D case geometries (host numpy, one-time setup).

A copy of the JAX package's geometry module: each shape provides a dense
boundary point set and an analytic inside-test used to blank solid cells
on the uniform grid. The resulting masks and SDF live on the device.

The canonical benchmark case is the reference's channel-with-obstacle
(Thesis_Work/Chapter5/parallelized/test_case: parabolic inlet, fixed-p
outlet, no-slip walls, Re_blockage=200).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cylinder:
    """Circular obstacle. Reference: Generate_blockMeshDict/cylinder
    (params r_int = radius, centred in the channel)."""

    cx: float
    cy: float
    r: float

    def boundary_points(self, n: int = 400) -> np.ndarray:
        th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        return np.stack([self.cx + self.r * np.cos(th),
                         self.cy + self.r * np.sin(th)], axis=-1)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        return (pts[:, 0] - self.cx) ** 2 + (pts[:, 1] - self.cy) ** 2 < self.r**2


@dataclasses.dataclass(frozen=True)
class Ellipse:
    """Elliptic obstacle. Reference: Generate_blockMeshDict/ellipse."""

    cx: float
    cy: float
    a: float  # semi-axis x
    b: float  # semi-axis y

    def boundary_points(self, n: int = 400) -> np.ndarray:
        th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        return np.stack([self.cx + self.a * np.cos(th),
                         self.cy + self.b * np.sin(th)], axis=-1)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        return ((pts[:, 0] - self.cx) / self.a) ** 2 + \
               ((pts[:, 1] - self.cy) / self.b) ** 2 < 1.0


def _polygon_boundary(verts: np.ndarray, n: int) -> np.ndarray:
    """Sample ~n points uniformly (by arclength) along a closed polygon."""
    verts = np.asarray(verts, dtype=np.float64)
    closed = np.vstack([verts, verts[:1]])
    seg = np.diff(closed, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    total = seg_len.sum()
    pts = []
    for k in range(len(verts)):
        m = max(int(round(n * seg_len[k] / total)), 1)
        t = np.linspace(0.0, 1.0, m, endpoint=False)[:, None]
        pts.append(closed[k] + t * seg[k])
    return np.concatenate(pts, axis=0)


def _polygon_inside(verts: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized even-odd point-in-polygon."""
    verts = np.asarray(verts, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), dtype=bool)
    n = len(verts)
    for k in range(n):
        x1, y1 = verts[k]
        x2, y2 = verts[(k + 1) % n]
        cond = (y1 > y) != (y2 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
        inside ^= cond & (x < np.where(cond, x_int, np.inf))
    return inside


@dataclasses.dataclass(frozen=True)
class Rectangle:
    """Rectangular obstacle. Reference: Generate_blockMeshDict/rectangle."""

    cx: float
    cy: float
    w: float
    h: float

    def _verts(self) -> np.ndarray:
        hw, hh = self.w / 2, self.h / 2
        return np.array([[self.cx - hw, self.cy - hh], [self.cx + hw, self.cy - hh],
                         [self.cx + hw, self.cy + hh], [self.cx - hw, self.cy + hh]])

    def boundary_points(self, n: int = 400) -> np.ndarray:
        return _polygon_boundary(self._verts(), n)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        return (np.abs(pts[:, 0] - self.cx) < self.w / 2) & \
               (np.abs(pts[:, 1] - self.cy) < self.h / 2)


@dataclasses.dataclass(frozen=True)
class Triangle:
    """Triangular obstacle. Reference: Generate_blockMeshDict/triangle."""

    cx: float
    cy: float
    size: float  # edge length of the equilateral triangle

    def _verts(self) -> np.ndarray:
        r = self.size / np.sqrt(3.0)
        th = np.array([np.pi / 2, np.pi / 2 + 2 * np.pi / 3, np.pi / 2 + 4 * np.pi / 3])
        return np.stack([self.cx + r * np.cos(th), self.cy + r * np.sin(th)], axis=-1)

    def boundary_points(self, n: int = 400) -> np.ndarray:
        return _polygon_boundary(self._verts(), n)

    def inside(self, pts: np.ndarray) -> np.ndarray:
        return _polygon_inside(self._verts(), pts)


@dataclasses.dataclass(frozen=True)
class ChannelCase:
    """A channel-with-obstacle case: domain box + obstacle + flow params.

    Matches the reference benchmark setup (parallelized/test_case):
    parabolic inlet with mean velocity `u_mean` on the west boundary, fixed
    p=0 on the east (outlet), no-slip top/bottom walls and obstacle,
    kinematic viscosity `nu` (transportProperties:20 -> nu = 8e-3 for
    Re_blockage = 200).
    """

    length: float
    height: float
    shape: object  # Cylinder | Rectangle | Triangle | Ellipse
    u_mean: float = 1.0
    nu: float = 8e-3

    def boundary_points_top(self, n: int = 2000) -> np.ndarray:
        """Outer walls (the reference's `top_bound` patch = domain boundary)."""
        verts = np.array([[0.0, 0.0], [self.length, 0.0],
                          [self.length, self.height], [0.0, self.height]])
        return _polygon_boundary(verts, n)

    def inlet_profile(self, y: np.ndarray) -> np.ndarray:
        """Parabolic inlet: u(y) = 6*u_mean*(y/H)*(1 - y/H) (0/U:26-45)."""
        t = y / self.height
        return 6.0 * self.u_mean * t * (1.0 - t)


def channel_case_geometry(shape_name: str = "cylinder",
                          length: float = 15.0,
                          height: float = 2.0,
                          obstacle_size: float = 0.5,
                          cx: float | None = None,
                          cy: float | None = None,
                          u_mean: float = 1.0,
                          nu: float = 8e-3) -> ChannelCase:
    """Build the canonical channel-with-obstacle case for a named shape.

    The parameter ranges mirror make_dataset.py's sweep (y_max in
    {0.5..1.0}, r ~ U(0.2, y/2)) scaled to the channel."""
    cx = length / 3.0 if cx is None else cx
    cy = height / 2.0 if cy is None else cy
    if shape_name == "cylinder":
        shp = Cylinder(cx, cy, obstacle_size / 2)
    elif shape_name == "rectangle":
        shp = Rectangle(cx, cy, obstacle_size, obstacle_size)
    elif shape_name == "triangle":
        shp = Triangle(cx, cy, obstacle_size)
    elif shape_name == "ellipse":
        shp = Ellipse(cx, cy, obstacle_size / 2, obstacle_size / 3)
    else:
        raise ValueError(f"unknown shape {shape_name!r}")
    return ChannelCase(length=length, height=height, shape=shp,
                       u_mean=u_mean, nu=nu)
