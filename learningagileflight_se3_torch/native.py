"""ctypes bindings of the native host library (`native/fastquad.cpp`).

Port of `learningagileflight_se3_tpu/native.py`.  `native/fastquad.cpp`
sits at the repo root, outside both packages, and has no framework in it:
high-throughput scenario sampling, an independent float64 plant written in
C++ and the host-side trajectory reward.  It is the third derivation of the
plant beside the PyTorch one and the numpy reference, so the tests and
`chip_smoke.py` hold the port's plant and reward against it.

The library is built at first use with g++ from `native/fastquad.cpp` into
`build/native/` (listed in .gitignore), keyed on a hash of the source and
flags.  Nothing is ever written under `native/`, whose prebuilt
`libfastquad.so` belongs to the JAX package.  `available()` is False where
no C++ toolchain exists; `library()` raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO_ROOT, "native", "fastquad.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
# native/Makefile's flags without -march=native, so that a build/ copied to
# another host still loads there (ISO C++ mode contracts no multiply-add
# either way, so the results are the same)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_dp = ctypes.POINTER(ctypes.c_double)


def _build() -> str:
    """Compile the library unless this source and these flags were built
    already; returns its path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ / c++) on PATH to build native/fastquad.cpp")
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libfastquad-{key}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building native/fastquad.cpp failed:\n{proc.stderr}")
            os.replace(tmp, path)  # atomic: concurrent builds race harmlessly
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    lib = ctypes.CDLL(_build())

    lib.fastquad_sample_scenarios.argtypes = [ctypes.c_uint64, ctypes.c_int64, _dp]
    lib.fastquad_sample_scenarios.restype = None

    lib.fastquad_euler_step.argtypes = [_dp, _dp, ctypes.c_double, _dp, _dp]
    lib.fastquad_euler_step.restype = None

    lib.fastquad_rollout.argtypes = [_dp, _dp, ctypes.c_int64, ctypes.c_double, _dp, _dp]
    lib.fastquad_rollout.restype = None

    lib.fastquad_collision_score.argtypes = [_dp, _dp, ctypes.c_int64, ctypes.c_double]
    lib.fastquad_collision_score.restype = ctypes.c_double

    lib.fastquad_trajectory_reward.argtypes = [
        _dp, ctypes.c_int64, _dp, _dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _dp,
    ]
    lib.fastquad_trajectory_reward.restype = ctypes.c_double
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
        return True
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False


def _as_c(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(_dp)


def _params_vec(params) -> np.ndarray:
    return np.array(
        [params.Jx, params.Jy, params.Jz, params.mass, params.l, params.c, params.g]
    )


def sample_scenarios(seed: int, n: int) -> np.ndarray:
    """(n, 9) scenario batch from the native sampler (quad_nn.py:18-48
    distribution; xoshiro PRNG: the same law, another stream than the
    port's torch sampler)."""
    out = np.empty((n, 9), dtype=np.float64)
    library().fastquad_sample_scenarios(ctypes.c_uint64(seed), n, out.ctypes.data_as(_dp))
    return out


def euler_step(x, u, dt: float, params) -> np.ndarray:
    x, xp = _as_c(x)
    u, up = _as_c(u)
    p, pp = _as_c(_params_vec(params))
    out = np.empty(13, dtype=np.float64)
    library().fastquad_euler_step(xp, up, dt, pp, out.ctypes.data_as(_dp))
    return out


def rollout(x0, U, dt: float, params) -> np.ndarray:
    x0, xp = _as_c(x0)
    U, Up = _as_c(U)
    p, pp = _as_c(_params_vec(params))
    H = U.shape[0]
    out = np.empty((H + 1, 13), dtype=np.float64)
    library().fastquad_rollout(xp, Up, H, dt, pp, out.ctypes.data_as(_dp))
    return out


def collision_score(gate_pts, tip_traj, horizon: int, d_min: float = 0.2) -> float:
    g, gp = _as_c(gate_pts)
    t, tp = _as_c(tip_traj)
    return float(library().fastquad_collision_score(gp, tp, horizon, d_min))


def trajectory_reward(
    states, gate_pts, goal, horizon: int,
    wing_len: float = 1.5, d_min: float = 0.2,
    collision_weight: float = 1000.0, path_weight: float = 0.5,
    offset: float = 100.0,
):
    """Returns (reward, collision_sum, path)."""
    s, sp = _as_c(states)
    g, gp = _as_c(gate_pts)
    go, gop = _as_c(goal)
    stats = np.zeros(2, dtype=np.float64)
    r = library().fastquad_trajectory_reward(
        sp, horizon, gp, gop, wing_len, d_min, collision_weight, path_weight,
        offset, stats.ctypes.data_as(_dp),
    )
    return float(r), float(stats[0]), float(stats[1])
