"""The port's PyBullet harness and asset generators
(`learningagileflight_se3_torch/sim/pybullet_harness.py`, `utils/urdf.py`,
`utils/mesh.py`) against the JAX package's, and the check that every module
this slice added imports with JAX blocked.

The live Bullet flight needs `pybullet` (`importorskip`, as in
tests/test_pybullet_harness.py); everything else runs everywhere.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.sim.pybullet_harness import _corners_to_pose as j_corners_to_pose
from learningagileflight_se3_tpu.utils import mesh as jmesh
from learningagileflight_se3_tpu.utils import urdf as jurdf

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.sim.pybullet_harness import _corners_to_pose
from learningagileflight_se3_torch.utils import mesh as tmesh
from learningagileflight_se3_torch.utils import urdf as turdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
NEW_MODULES = (
    "learningagileflight_se3_torch.oracle",
    "learningagileflight_se3_torch.oracle.numpy_reference",
    "learningagileflight_se3_torch.oracle.derivatives",
    "learningagileflight_se3_torch.oracle.shooting",
    "learningagileflight_se3_torch.oracle.lifted_nlp",
    "learningagileflight_se3_torch.native",
    "learningagileflight_se3_torch.sim.pybullet_harness",
    "learningagileflight_se3_torch.utils.urdf",
    "learningagileflight_se3_torch.utils.mesh",
    "learningagileflight_se3_torch.solver.ilqr",
    "learningagileflight_se3_torch.entry",
)


def test_corners_to_pose_matches_jax(rng):
    """Seeded gates of every pitch (both of Shepperd's branches), moved
    anywhere: the pose equals the JAX function's and maps the URDF's local
    corner layout back onto the corners."""
    for _ in range(12):
        w, hh = rng.uniform(0.3, 1.5), rng.uniform(0.3, 1.0)
        pitch, shift = rng.uniform(-np.pi, np.pi), rng.uniform(-3, 3, size=3)
        pts = np.asarray(jgate.translate(jgate.rotate_y(jgate.gate_from_width(jnp.asarray(w), half_height=hh),
                                                        pitch), jnp.asarray(shift)))
        c, q_xyzw = _corners_to_pose(pts)
        c_ref, q_ref = j_corners_to_pose(pts)
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_array_equal(q_xyzw, q_ref)
        x, y, z, wq = q_xyzw
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * wq), 2 * (x * z + y * wq)],
            [2 * (x * y + z * wq), 1 - 2 * (x * x + z * z), 2 * (y * z - x * wq)],
            [2 * (x * z - y * wq), 2 * (y * z + x * wq), 1 - 2 * (x * x + y * y)],
        ])
        local = np.array([[-w / 2, 0, hh], [w / 2, 0, hh], [w / 2, 0, -hh], [-w / 2, 0, -hh]])
        np.testing.assert_allclose(local @ R.T + c, pts, atol=1e-9)


def test_assets_equal_jax_generators_and_committed_files():
    """The port's URDF and OBJ text equals the JAX generators' output, and at
    scripts/gen_assets.py's defaults (width 1, half height 1) the committed
    assets/ files."""
    p_t, p_j = tcfg.QuadParams(), jcfg.QuadParams()
    committed = {
        "hb.urdf": turdf.quad_urdf(p_t),
        "window.urdf": turdf.window_urdf(1.0, 1.0),
        "window_frozen.urdf": turdf.window_urdf(1.0, 1.0, frozen=True),
        "quad.obj": tmesh.quad_obj(p_t),
        "quad.mtl": tmesh.QUAD_MTL,
        "window.obj": tmesh.window_obj(1.0, 1.0),
        "window.mtl": tmesh.WINDOW_MTL,
    }
    for name, text in committed.items():
        with open(os.path.join(ASSETS, name)) as f:
            assert f.read() == text, name
    assert turdf.quad_urdf(p_t, thrust2weight=2.5) == jurdf.quad_urdf(p_j, thrust2weight=2.5)
    assert turdf.KF == jurdf.KF
    for width, hh in ((0.35, 0.5), (0.8, 0.4), (1.3, 0.8)):
        assert turdf.window_urdf(width, hh) == jurdf.window_urdf(width, hh)
        assert turdf.window_urdf(width, hh, frozen=True, bar=0.03, mass=2.0) == \
            jurdf.window_urdf(width, hh, frozen=True, bar=0.03, mass=2.0)
        assert tmesh.window_obj(width, hh) == jmesh.window_obj(width, hh)
    assert tmesh.quad_obj(p_t) == jmesh.quad_obj(p_j)
    assert tmesh.parse_obj(tmesh.quad_obj(p_t)) == jmesh.parse_obj(jmesh.quad_obj(p_j))


def test_harness_import_is_guarded():
    """Importing the harness never imports pybullet; without pybullet the
    run raises an ImportError that names it."""
    from learningagileflight_se3_torch.sim import pybullet_harness

    if importlib.util.find_spec("pybullet") is not None:
        pytest.skip("pybullet is installed here")
    assert "pybullet" not in sys.modules
    with pytest.raises(ImportError, match="pybullet"):
        pybullet_harness._require_pybullet()
    with pytest.raises(ImportError, match="pybullet"):
        pybullet_harness.run_pybullet_sim(torch.nn.Linear(18, 1), device="cpu")


def test_new_modules_import_without_jax():
    """Every module of this slice imports in a fresh interpreter where
    `import jax` and the JAX package fail (the flagship entry also builds
    its forward step and loads its example arguments there), and none pulls
    in pybullet."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['learningagileflight_se3_tpu'] = None\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from learningagileflight_se3_torch.solver.ilqr import make_mpc_solver\n"
        "from learningagileflight_se3_torch.entry import entry\n"
        "entry(device='cpu')\n"
        "assert 'pybullet' not in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_pybullet_live():
    """The shipped DNN2 flown in Bullet for 2 s on the CPU (the JAX live
    test's gates)."""
    pytest.importorskip("pybullet")
    from learningagileflight_se3_torch.sim.pybullet_harness import run_pybullet_sim
    from learningagileflight_se3_torch.sim.validation_sim import ValidationSimConfig
    from learningagileflight_se3_torch.utils.weights import load_dnn2

    res = run_pybullet_sim(load_dnn2(), cfg=ValidationSimConfig(duration_sec=2.0),
                           params=tcfg.QuadParams(), seed=3, device="cpu")
    assert res["engine"] == "pybullet"
    assert np.all(np.isfinite(res["states"]))
    assert res["states"][-1, 2] > res["states"][0, 2] - 5.0
    assert res["physical_gate"]
    if res["through_gate"] and res["gate_margin"] > tcfg.QuadParams().l / 2:
        assert res["n_contact_steps"] == 0, f"engine contact on a clean traversal: {res['contacts'][:5]}"
