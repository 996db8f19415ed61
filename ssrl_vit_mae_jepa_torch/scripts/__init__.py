"""The port's command-line entry points, module for module those of the
repository's ``scripts/`` package (``python -m
ssrl_vit_mae_jepa_torch.scripts.training.pretrain_mae`` is the counterpart
of ``python -m scripts.training.pretrain_mae``). Each CLI has
``main(argv=None)`` and runs on the device that ``scripts/utils.py::device``
names: the card unless ``SSRL_TORCH_DEVICE=cpu``."""
