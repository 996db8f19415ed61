"""The PyTorch port imports neither JAX nor flax, and its chip smoke refuses
to run without a GPU.

Both checks run in a subprocess: this test process has JAX loaded already
(``tests/conftest.py``)."""

import pathlib
import subprocess
import sys

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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax"))
assert not bad, bad
print(len(names))
"""


def _run(args, timeout=120):
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=scrubbed_cpu_env(),
        capture_output=True, text=True, timeout=timeout,
    )


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12  # every module of the port


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
