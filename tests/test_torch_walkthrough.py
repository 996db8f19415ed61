"""``examples/torch_walkthrough.py``, the port's end-to-end demo, on the CPU:
its five stages end to end at one epoch, its refusal to fall back on the
CPU, and the config and synthetic-data sizes it builds against those of
``examples/walkthrough.py`` (the JAX script runs only as far as its first
loader, which records the config and raises, so no JAX training runs).

The scripts run in process. TensorBoard is an optional dependency of both
packages' metrics loggers, and its import alone takes ~10 s here, so the
end-to-end case hides it (the loggers then write ``metrics.jsonl`` only).
"""

import ast
import importlib.util
import math
import re
import sys
from pathlib import Path

import pytest
import torch

import ssrl_vit_mae_jepa_torch.data.loaders as t_loaders
import ssrl_vit_mae_jepa_torch.data.stl10 as t_stl10
import ssrl_vit_mae_jepa_tpu.data.loaders as j_loaders
import ssrl_vit_mae_jepa_tpu.data.stl10 as j_stl10
from ssrl_vit_mae_jepa_torch.utils.checkpoint import load_checkpoint, model_state

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("walk") / "data"
    # 24 labeled images a class: the probe's 20 a class and a validation split
    t_stl10.write_synthetic_stl10(d, num_train=240, num_test=32, num_unlabeled=48)
    return d


def test_walkthrough_runs_end_to_end_on_the_cpu(data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SSRL_TORCH_DEVICE", "cpu")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _script("torch_walkthrough").main(["--epochs", "1", "--batch_size", "16",
                                       "--data_dir", str(data), "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    for stage in ("1. MAE pretraining", "2. Frozen linear probe", "3. Test evaluation",
                  "4. Reconstruction"):
        assert f"=== {stage} ===" in out
    best = tmp_path / "pretrain" / "checkpoints" / "best.ckpt"
    ckpt = load_checkpoint(best)
    weights = model_state(ckpt)
    assert ckpt["epoch"] == 0 and math.isfinite(ckpt["metrics"]["val_loss"])
    assert any(k.startswith("decoder.") for k in weights)
    assert all(torch.isfinite(v).all() for v in weights.values())
    assert (tmp_path / "train" / "checkpoints" / "best.ckpt").exists()
    losses = [float(x) for x in re.findall(r"'(?:train|val)_loss': ([-0-9.e]+)", out)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    metrics = ast.literal_eval(re.search(r"test metrics: (\{.*\})", out).group(1))
    assert set(metrics) == {"test_loss", "test_acc", "test_top5"}
    assert math.isfinite(metrics["test_loss"]) and 0 <= metrics["test_acc"] <= 1
    psnr, mse = map(float, re.search(r"masked-patch PSNR: ([-0-9.]+) dB \(MSE ([0-9.]+)\)",
                                     out).groups())
    assert math.isfinite(psnr) and mse > 0


def test_walkthrough_refuses_to_fall_back_without_a_card(data, tmp_path, monkeypatch):
    assert not torch.cuda.is_available()
    monkeypatch.delenv("SSRL_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("torch_walkthrough").main(["--data_dir", str(data),
                                           "--workdir", str(tmp_path)])
    assert not (tmp_path / "pretrain").exists()


class _Stop(Exception):
    pass


def _capture(monkeypatch, loaders, stl10, run):
    """The sizes the script writes its synthetic STL-10 with and the config
    it hands its first loader."""
    seen = {}

    def write(data_dir, **sizes):
        seen["sizes"] = sizes

    def first_loader(cfg, data_dir=None):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(stl10, "write_synthetic_stl10", write)
    monkeypatch.setattr(loaders, "get_pretrain_dataloaders", first_loader)
    with pytest.raises(_Stop):
        run()
    return seen


@pytest.mark.parametrize("argv", [[], ["--epochs", "5", "--batch_size", "32"]])
def test_walkthrough_builds_the_jax_walkthroughs_config(tmp_path, monkeypatch, argv):
    monkeypatch.setenv("SSRL_TORCH_DEVICE", "cpu")
    mine = _capture(monkeypatch, t_loaders, t_stl10, lambda: _script("torch_walkthrough").main(
        ["--workdir", str(tmp_path / "torch"), *argv]))
    jax_script = _script("walkthrough")
    monkeypatch.setattr(sys, "argv", ["walkthrough.py", "--workdir", str(tmp_path / "jax"),
                                      *argv])
    want = _capture(monkeypatch, j_loaders, j_stl10, jax_script.main)
    assert want["sizes"] == {"num_train": 400, "num_test": 200, "num_unlabeled": 1000}
    assert mine["sizes"] == want["sizes"]
    assert mine["cfg"] == want["cfg"]
