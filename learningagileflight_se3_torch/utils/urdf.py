"""URDF generators for the external-simulator assets (component #27).

The port's own copy of `learningagileflight_se3_tpu/utils/urdf.py` (importing
the original loads JAX through its package); tests/test_torch_pybullet_harness.py
holds its output equal to the original's and to the committed `assets/`.

The reference ships hand-authored URDFs (gym_pybullet_drone/model/hb.urdf,
window.urdf, window_frozen.urdf — loaded by GateAviary.py:23-104).  Here the
equivalents are GENERATED from the framework's typed config so the physical
parameters can never drift from the trained model.  `scripts/gen_assets.py`
is the CLI that writes the committed `assets/`; `sim/pybullet_harness.py`
calls `window_urdf` directly to build the per-scenario PHYSICAL gate body it
loads into Bullet (the opening width/height are scenario inputs, so a fixed
committed file cannot cover them — the reference solves this by rewriting a
scaled copy of the URDF per run, GateAviary.py `scaled_model`).
"""

from __future__ import annotations

from learningagileflight_se3_torch.config import QuadParams

KF = 6.11e-8  # rotor thrust coefficient [N/RPM^2] (model/hb.urdf)


def quad_urdf(p: QuadParams, thrust2weight: float = 2.0) -> str:
    arm = p.l / 2.0
    km = KF * p.c  # torque coeff c == km/kf (quad_model.py:91 vs hb.urdf)
    rotors = []
    # plus configuration, rotor order f1..f4 matching the mixer
    # Mx=(-f2+f4)l/2, My=(-f1+f3)l/2 (quad_model.py:89-90): f1 +x, f2 +y,
    # f3 -x, f4 -y.
    for i, (x, y) in enumerate([(arm, 0.0), (0.0, arm), (-arm, 0.0), (0.0, -arm)]):
        rotors.append(f"""
  <link name="prop{i}">
    <inertial>
      <mass value="0"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
    <visual>
      <origin xyz="0 0 0"/>
      <geometry><cylinder radius="0.06" length="0.004"/></geometry>
    </visual>
  </link>
  <joint name="prop{i}_joint" type="fixed">
    <parent link="base_link"/>
    <child link="prop{i}"/>
    <origin xyz="{x:.4f} {y:.4f} 0.02"/>
  </joint>""")
    return f"""<?xml version="1.0" ?>
<!-- GENERATED by scripts/gen_assets.py from QuadParams; do not hand-edit. -->
<robot name="hb">
  <properties arm="{arm:.4f}" kf="{KF:.6e}" km="{km:.6e}"
              thrust2weight="{thrust2weight}" max_speed_kmh="30"
              gnd_eff_coeff="11.36859" prop_radius="0.06"
              drag_coeff_xy="0" drag_coeff_z="0"
              dw_coeff_1="0" dw_coeff_2="0" dw_coeff_3="0"/>
  <link name="base_link">
    <inertial>
      <origin xyz="0 0 0"/>
      <mass value="{p.mass}"/>
      <inertia ixx="{p.Jx}" ixy="0" ixz="0" iyy="{p.Jy}" iyz="0" izz="{p.Jz}"/>
    </inertial>
    <visual>
      <origin xyz="0 0 0"/>
      <geometry><box size="{p.l:.4f} {p.l:.4f} 0.05"/></geometry>
    </visual>
    <collision>
      <origin xyz="0 0 0"/>
      <geometry><sphere radius="{arm:.4f}"/></geometry>
    </collision>
  </link>{''.join(rotors)}
</robot>
"""


def window_urdf(width: float, half_height: float, frozen: bool = False,
                bar: float = 0.05, mass: float = 1.0) -> str:
    """A rigid frame of four box bars around a (width x 2*half_height)
    opening in the x-z plane (the gate_from_width corner layout,
    geometry/gate.py), with its origin at the opening's centroid."""
    h = 2.0 * half_height
    ww = width + 2 * bar
    parts = []
    for name, size, xyz in [
        ("top",    (ww, bar, bar), (0.0, 0.0, half_height + bar / 2)),
        ("bottom", (ww, bar, bar), (0.0, 0.0, -half_height - bar / 2)),
        ("left",   (bar, bar, h),  (-width / 2 - bar / 2, 0.0, 0.0)),
        ("right",  (bar, bar, h),  (width / 2 + bar / 2, 0.0, 0.0)),
    ]:
        sx, sy, sz = size
        x, y, z = xyz
        parts.append(f"""
    <visual>
      <origin xyz="{x:.4f} {y:.4f} {z:.4f}"/>
      <geometry><box size="{sx:.4f} {sy:.4f} {sz:.4f}"/></geometry>
    </visual>
    <collision>
      <origin xyz="{x:.4f} {y:.4f} {z:.4f}"/>
      <geometry><box size="{sx:.4f} {sy:.4f} {sz:.4f}"/></geometry>
    </collision>""")
    fixed = """
  <link name="world"/>
  <joint name="anchor" type="fixed">
    <parent link="world"/>
    <child link="frame"/>
  </joint>""" if frozen else ""
    return f"""<?xml version="1.0" ?>
<!-- GENERATED by scripts/gen_assets.py; opening {width} x {h} m. -->
<robot name="window{'_frozen' if frozen else ''}">
  <link name="frame">
    <inertial>
      <origin xyz="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" izz="0.1"/>
    </inertial>{''.join(parts)}
  </link>{fixed}
</robot>
"""
