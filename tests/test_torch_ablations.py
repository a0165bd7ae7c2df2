"""PyTorch port, the two ablation drivers (scripts/torch_ablate_rl.py,
scripts/torch_ablate_imitation.py) on the CPU at a tiny size.

Each script's `main` runs with `--device cpu`; its JSON carries the keys of
the JAX package's records (artifacts/ablate_rl_r3.json,
runs/ablate_imitation/ablation.json) with finite values, the file it
writes equals what it returns, and it saved each variant's network.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_record(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def _check(out, out_dir, record, variant_of):
    with open(os.path.join(out_dir, "ablation.json")) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert set(record["meta"]) <= set(out["meta"]) and out["meta"]["platform"] == "cpu"
    for name, res in out["results"].items():
        want = record["results"][variant_of(name)]
        assert set(res) == set(want), name
        assert all(np.isfinite(v) for v in res.values()), (name, res)


def test_ablate_rl_main_on_cpu(tmp_path):
    mod = _script("torch_ablate_rl")
    assert mod.parse_variant("analytic400sched") == ("analytic", 400, True)
    assert mod.parse_variant("fd100") == ("fd", 100, False)
    out_dir = str(tmp_path / "rl")
    out = mod.main(["--device", "cpu", "--horizon", "6", "--batch", "4", "--eval-scenarios", "4",
                    "--variants", "fd2,analytic2sched", "--out", out_dir])
    assert list(out["results"]) == ["pretrain", "fd2", "analytic2sched"]
    record = _jax_record("artifacts/ablate_rl_r3.json")
    _check(out, out_dir, record, lambda n: "pretrain" if n == "pretrain" else "fd400sched")
    for name in ("fd2", "analytic2sched"):
        assert os.path.isfile(os.path.join(out_dir, f"nn_deep_{name}", "params.pt"))
        assert np.load(os.path.join(out_dir, f"curve_{name}.npy")).shape == (2,)


def test_ablate_imitation_main_on_cpu(tmp_path):
    mod = _script("torch_ablate_imitation")
    out_dir = str(tmp_path / "imi")
    out = mod.main(["--device", "cpu", "--horizon", "6", "--max-iters", "6", "--epochs", "2",
                    "--batch-scenarios", "4", "--sgd-passes", "2", "--eval-scenarios", "4",
                    "--sim-steps", "20", "--out", out_dir])
    assert list(out["results"]) == ["world", "window", "window_consistent"]
    record = _jax_record("runs/ablate_imitation/ablation.json")
    _check(out, out_dir, record, lambda n: n)
    for name in out["results"]:
        assert os.path.isfile(os.path.join(out_dir, f"nn3_{name}", "params.pt"))


@pytest.mark.parametrize("name", ["torch_ablate_rl", "torch_ablate_imitation"])
def test_ablation_unknown_variant_raises(tmp_path, name):
    with pytest.raises(ValueError, match="sgd3"):
        _script(name).main(["--device", "cpu", "--variants", "sgd3", "--out", str(tmp_path),
                            "--eval-scenarios", "2", "--horizon", "4"]
                           + (["--batch", "2"] if name == "torch_ablate_rl" else ["--epochs", "1"]))
