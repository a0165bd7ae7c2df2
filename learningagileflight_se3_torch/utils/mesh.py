"""Wavefront OBJ mesh generators for the visual assets (component #27).

The port's own copy of `learningagileflight_se3_tpu/utils/mesh.py` (importing
the original loads JAX through its package); tests/test_torch_pybullet_harness.py
holds its output equal to the original's and to the committed `assets/`.

The reference ships hand-authored visual meshes
(`gym_pybullet_drone/model/quad.obj`, `window.obj`/`.mtl` — referenced by
its URDFs for GUI rendering).  Cosmetic only (collision uses primitive
shapes), but part of the asset inventory: here they are GENERATED from the
same typed config as the URDFs so the rendered vehicle/gate match the
physical parameters exactly.  Pure text emitters — no mesh library.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from learningagileflight_se3_torch.config import QuadParams


class _ObjBuilder:
    def __init__(self):
        self.lines: List[str] = ["# GENERATED by scripts/gen_assets.py"]
        self.nv = 0

    def use_material(self, name: str):
        self.lines.append(f"usemtl {name}")

    def add_box(self, cx, cy, cz, sx, sy, sz):
        """Axis-aligned box centered at (cx,cy,cz) with full sizes (sx,sy,sz)."""
        hx, hy, hz = sx / 2, sy / 2, sz / 2
        corners = [
            (cx - hx, cy - hy, cz - hz), (cx + hx, cy - hy, cz - hz),
            (cx + hx, cy + hy, cz - hz), (cx - hx, cy + hy, cz - hz),
            (cx - hx, cy - hy, cz + hz), (cx + hx, cy - hy, cz + hz),
            (cx + hx, cy + hy, cz + hz), (cx - hx, cy + hy, cz + hz),
        ]
        for v in corners:
            self.lines.append(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}")
        b = self.nv  # 1-based face indices offset
        faces = [(1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5),
                 (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8)]
        for f in faces:
            self.lines.append("f " + " ".join(str(b + i) for i in f))
        self.nv += 8

    def add_cylinder(self, cx, cy, cz, radius, height, n=16):
        """Z-aligned closed cylinder centered at (cx,cy,cz)."""
        hz = height / 2
        for z in (cz - hz, cz + hz):
            for k in range(n):
                a = 2 * math.pi * k / n
                self.lines.append(
                    f"v {cx + radius * math.cos(a):.5f} "
                    f"{cy + radius * math.sin(a):.5f} {z:.5f}"
                )
        b = self.nv
        bot = [b + 1 + k for k in range(n)]
        top = [b + n + 1 + k for k in range(n)]
        self.lines.append("f " + " ".join(str(i) for i in reversed(bot)))
        self.lines.append("f " + " ".join(str(i) for i in top))
        for k in range(n):
            k2 = (k + 1) % n
            self.lines.append(f"f {bot[k]} {bot[k2]} {top[k2]} {top[k]}")
        self.nv += 2 * n

    def text(self, mtllib: str = "") -> str:
        head = [f"mtllib {mtllib}"] if mtllib else []
        return "\n".join(self.lines[:1] + head + self.lines[1:]) + "\n"


def quad_obj(p: QuadParams) -> str:
    """Plus-configuration quadrotor: center body box, four arms, four rotor
    discs at the mixer's rotor positions (f1 +x, f2 +y, f3 -x, f4 -y —
    quad_model.py:89-90 / assets/hb.urdf)."""
    arm = p.l / 2.0
    b = _ObjBuilder()
    b.use_material("body")
    b.add_box(0, 0, 0, 0.12, 0.12, 0.05)
    for (x, y), along_x in [((arm / 2, 0), True), ((0, arm / 2), False),
                            ((-arm / 2, 0), True), ((0, -arm / 2), False)]:
        if along_x:
            b.add_box(x, y, 0, arm, 0.02, 0.02)
        else:
            b.add_box(x, y, 0, 0.02, arm, 0.02)
    b.use_material("rotor")
    for x, y in [(arm, 0), (0, arm), (-arm, 0), (0, -arm)]:
        b.add_cylinder(x, y, 0.02, 0.06, 0.008)
    return b.text(mtllib="quad.mtl")


def window_obj(width: float, half_height: float, bar: float = 0.05) -> str:
    """The four-bar window frame, identical geometry to utils/urdf.window_urdf
    (opening in the x-z plane, origin at the centroid)."""
    h = 2.0 * half_height
    ww = width + 2 * bar
    b = _ObjBuilder()
    b.use_material("frame")
    b.add_box(0, 0, half_height + bar / 2, ww, bar, bar)
    b.add_box(0, 0, -half_height - bar / 2, ww, bar, bar)
    b.add_box(-width / 2 - bar / 2, 0, 0, bar, bar, h)
    b.add_box(width / 2 + bar / 2, 0, 0, bar, bar, h)
    return b.text(mtllib="window.mtl")


QUAD_MTL = """# GENERATED by scripts/gen_assets.py
newmtl body
Kd 0.15 0.15 0.18
newmtl rotor
Kd 0.75 0.10 0.10
"""

WINDOW_MTL = """# GENERATED by scripts/gen_assets.py
newmtl frame
Kd 0.80 0.55 0.10
"""


def parse_obj(text: str) -> Tuple[list, list]:
    """Minimal OBJ reader for tests: -> (vertices [(x,y,z)], faces [[i..]])."""
    verts, faces = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append(tuple(float(x) for x in parts[1:4]))
        elif parts[0] == "f":
            faces.append([int(i.split("/")[0]) for i in parts[1:]])
    return verts, faces
