"""The port's command-line entry points, module for module those of the
repository's ``scripts/`` package (``python -m
ssrl_vit_mae_jepa_torch.scripts.training.pretrain_mae`` is the counterpart
of ``python -m scripts.training.pretrain_mae``). Each CLI has
``main(argv=None)`` and runs on the device that ``scripts/utils.py::device``
names: the card unless ``SSRL_TORCH_DEVICE=cpu``.

With ``SSRL_LAUNCH_LOG=<file>`` set, a CLI process appends its kernel launch
counts (the nonzero ``LAUNCHES`` counters of the kernel wrappers it
imported) to that file as one JSON line when it exits, so a script that
runs CLIs as processes, such as ``tools/torch_rank_study.sh``, can sum them.
"""

import atexit
import json
import os
import sys

LAUNCH_LOG_ENV = "SSRL_LAUNCH_LOG"
_COUNTER_MODULES = ("ops.block_fused", "ops.block_chain", "ops.attention_core",
                    "ops.embed_fused")


def write_launches(path: str) -> None:
    """Append this process's nonzero launch counters to ``path``."""
    counts = {}
    for name in _COUNTER_MODULES:
        mod = sys.modules.get(f"ssrl_vit_mae_jepa_torch.{name}")
        if mod is not None:
            counts.update({k: v for k, v in mod.LAUNCHES.items() if v})
    with open(path, "a") as f:
        f.write(json.dumps({"cli": os.path.basename(sys.argv[0]), "launches": counts}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(write_launches, os.environ[LAUNCH_LOG_ENV])
