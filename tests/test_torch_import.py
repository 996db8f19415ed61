"""The PyTorch port imports neither JAX, flax, optax, msgpack nor anything of
the JAX package, and its chip smoke refuses to run without a GPU.

Both checks run in a subprocess: this test process has JAX loaded already
(``tests/conftest.py``)."""

import pathlib
import subprocess
import sys

import pytest
import yaml

from tests.conftest import scrubbed_cpu_env

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ssrl_vit_mae_jepa_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "msgpack", "ssrl_vit_mae_jepa_tpu"))
assert not bad, bad
print(" ".join(names))
"""
# the modules of the JEPA slice, the fused patch embed, the chained blocks,
# the classifier stage with its engine and data path, the CLIs, the data
# and tensor parallelism and the checkpoint-fidelity CLIs, among all others
CLI_MODULES = {"scripts.utils", "scripts.data", "scripts.training.pretrain_mae",
               "scripts.training.train_mae", "scripts.training.pretrain_jepa",
               "scripts.evaluation.evaluate_classifier", "scripts.evaluation.knn_eval",
               "scripts.evaluation.validate_instrument",
               "scripts.evaluation.visualize_reconstruction",
               "scripts.evaluation.visualize_representation",
               "scripts.evaluation.visualize_test_accuracy",
               "scripts.evaluation.visualize_val_acc_by_mode", "scripts.ablation.common",
               "scripts.ablation.run_pretrain_ablation", "scripts.ablation.run_train_ablation",
               "scripts.ablation.run_baseline_ablation", "scripts.weight_utils.extract_weights",
               "scripts.weight_utils.copy_ckpts", "scripts.weight_utils.convert_to_torch",
               "scripts.evaluation.parity_check", "scripts.evaluation.run_parity_protocol",
               "scripts.weight_utils.convert_torch_checkpoint"}
NEW_MODULES = {"config", "ops.jepa_masking", "ops.embed_fused", "models.jepa",
               "training.jepa_task", "ops.block_chain", "ops.block_fused",
               "models.classifier", "training.trainer", "utils.checkpoint", "utils.load",
               "utils.metrics_logger", "data.stl10", "data.pipeline", "data.loaders",
               "runtime.native", "utils.umap_np", "utils.profiling", "parallel",
               "parallel.mesh", "parallel.multihost", "parallel.tensor", "bench", "utils.flops",
               "utils.flax_msgpack", "utils.interop"} | CLI_MODULES


def _run(args, timeout=120):
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=scrubbed_cpu_env(),
        capture_output=True, text=True, timeout=timeout,
    )


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 74  # every module of the port, the CLIs' among them
    assert {f"ssrl_vit_mae_jepa_torch.{m}" for m in NEW_MODULES} <= set(names)


def test_cli_without_a_card_refuses_to_run_on_the_cpu(tmp_path):
    """With the default device (``SSRL_TORCH_DEVICE`` unset) and no card, a
    CLI stops at once with a clear error and writes nothing; with
    ``SSRL_TORCH_DEVICE=cpu`` the device is the CPU."""
    cfg = yaml.safe_load((REPO / "configs" / "mae.yaml").read_text())
    cfg["logging"]["output_dir_base"] = str(tmp_path / "outputs")
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    env = scrubbed_cpu_env()
    env.pop("SSRL_TORCH_DEVICE", None)
    for module in ("training.pretrain_mae", "training.train_mae", "training.pretrain_jepa"):
        proc = subprocess.run(
            [sys.executable, "-m", f"ssrl_vit_mae_jepa_torch.scripts.{module}",
             "--config", str(tmp_path / "cfg.yaml")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr and "SSRL_TORCH_DEVICE=cpu" in proc.stderr
    assert not (tmp_path / "outputs").exists()
    proc = _run(["-c", "import os; os.environ['SSRL_TORCH_DEVICE'] = 'cpu'; "
                 "from ssrl_vit_mae_jepa_torch.scripts.utils import device; print(device())"])
    assert proc.returncode == 0 and proc.stdout.strip() == "cpu"


def test_device_is_read_in_one_place(monkeypatch):
    from ssrl_vit_mae_jepa_torch.scripts import utils

    monkeypatch.delenv("SSRL_TORCH_DEVICE", raising=False)
    if utils.torch.cuda.is_available():
        assert utils.device() == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            utils.device()
    monkeypatch.setenv("SSRL_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="tpu"):
        utils.device()


def test_chip_smoke_imports_nothing_of_the_jax_package():
    proc = _run(["-c", "import sys, chip_smoke; "
                 "print(sorted(m for m in sys.modules if m.startswith('ssrl_vit_mae_jepa_tpu')))"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_fails_without_a_gpu():
    """Without a card the script exits nonzero and prints no result line."""
    proc = _run(["chip_smoke.py"], timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_model_config_is_the_default():
    """chip_smoke reads the flagship geometry from configs/mae.yaml; it is
    the JAX package's DEFAULTS["model"]."""
    from ssrl_vit_mae_jepa_tpu.config import DEFAULTS

    cfg = yaml.safe_load((REPO / "configs" / "mae.yaml").read_text())["model"]
    for section in ("general", "encoder", "decoder"):
        assert cfg[section] == DEFAULTS["model"][section]


def test_step_profile_needs_a_gpu():
    """The step profiler imports nothing of JAX and exits nonzero without a
    card."""
    proc = _run(["-c", "import runpy, sys; sys.argv = ['p', '--attn-impl', 'packed']; "
                 "runpy.run_path('tools/torch_step_profile.py', run_name='__main__')"])
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    proc = _run(["-c", "import runpy, sys; runpy.run_path('tools/torch_step_profile.py'); "
                 "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('jax', 'flax', 'optax', 'ssrl_vit_mae_jepa_tpu')))"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("script", ["examples/torch_walkthrough.py",
                                    "tools/torch_pretrain_curves.py"])
def test_entry_scripts_import_only_the_port(script):
    """Every import statement of the port's entry scripts (at the top and
    inside functions) names torch-side modules only; each port module they
    name is JAX-free by ``test_port_imports_no_jax``."""
    import ast
    import importlib.util

    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "ssrl_vit_mae_jepa_tpu", "scripts"}
    names = []
    for node in ast.walk(ast.parse((REPO / script).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names and not {n.split(".")[0] for n in names} & banned, names
    port = [n for n in names if n.startswith("ssrl_vit_mae_jepa_torch")]
    assert port and all(importlib.util.find_spec(n) is not None for n in port), port
