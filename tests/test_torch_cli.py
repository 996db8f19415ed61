"""The port's CLIs (``ssrl_vit_mae_jepa_torch/scripts``) on the CPU, in
process, at the tiny geometry of ``tests/test_cli.py`` (D=32, depth 2,
decoder depth 1) on a synthetic STL-10 (60 train, 40 test, 120 unlabeled).

Held to the JAX package's CLI contract: the chain pretrain → probe from
``--encoder_ckpt`` → evaluate and JEPA → probe with the output layout and
file names of ``scripts/training/*``; the per-step records and periodic
weights-only files against the JAX ``Trainer`` at the same settings; the
freeze precedence against ``scripts/training/train_mae.py``'s own decision;
the weights files both ways (the port's exports equal the JAX export of the
same parameters bit for bit, and the JAX export trains in the port);
``evaluate_checkpoint`` through both packages; and each ablation driver's
launched commands against the JAX driver's, with ``subprocess.run`` patched.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from ssrl_vit_mae_jepa_torch.data import loaders as t_loaders
from ssrl_vit_mae_jepa_torch.data.stl10 import write_synthetic_stl10
from ssrl_vit_mae_jepa_torch.scripts import utils as t_utils
from ssrl_vit_mae_jepa_torch.scripts.ablation import run_baseline_ablation as t_base
from ssrl_vit_mae_jepa_torch.scripts.ablation import run_pretrain_ablation as t_pre
from ssrl_vit_mae_jepa_torch.scripts.ablation import run_train_ablation as t_train
from ssrl_vit_mae_jepa_torch.scripts.evaluation import evaluate_classifier as t_eval
from ssrl_vit_mae_jepa_torch.scripts.training import pretrain_jepa as t_pretrain_jepa
from ssrl_vit_mae_jepa_torch.scripts.training import pretrain_mae as t_pretrain_mae
from ssrl_vit_mae_jepa_torch.scripts.training import train_mae as t_train_mae
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
from ssrl_vit_mae_jepa_torch.utils.interop import classifier_params_to_state
from ssrl_vit_mae_jepa_torch.utils.load import encoder_params_from_checkpoint as t_encoder
from ssrl_vit_mae_jepa_tpu.data import loaders as j_loaders
from ssrl_vit_mae_jepa_tpu.training.optim import trainable_mask as j_trainable_mask
from ssrl_vit_mae_jepa_tpu.utils import load as j_load
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti

MODEL = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 32, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
    "head": {"embed_dim": 32, "pool": "cls"},
}
PRETRAIN = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
            "total_epochs": 2, "warmup_epochs": 1, "batch_size": 16,
            "base_learning_rate": 1.5e-4, "weight_decay": 0.05, "data_fraction": 1.0,
            "val_split": 0.1}
TRAIN = {"samples_per_class": 4, "total_epochs": 2, "warmup_epochs": 1, "batch_size": 16,
         "learning_rate": 1e-3, "weight_decay": 0.05, "freeze_encoder": True}
JEPA = {"total_epochs": 2, "warmup_epochs": 1, "batch_size": 16, "base_learning_rate": 1.5e-4,
        "weight_decay": 0.05, "data_fraction": 1.0, "val_split": 0.1,
        "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
        "num_target_blocks": 4, "ema_start": 0.99, "ema_end": 1.0}
# what each training CLI writes into its run directory (scripts/training/*.py
# of the JAX package: config snapshot, metrics, checkpoints, the weights file)
RUN_FILES = {"config.yaml", "metrics.jsonl", "checkpoints/best.ckpt", "checkpoints/last.ckpt"}


def _write_cfg(root: Path, name: str, **over) -> Path:
    cfg = {"model": MODEL, "pretrain": PRETRAIN, "train": TRAIN, "jepa": JEPA,
           "test": {"batch_size": 16},
           "logging": {"output_dir_base": str(root / "outputs"), "model_path": "vit-mae.pt"}}
    for section, values in over.items():
        cfg[section] = {**cfg[section], **values}
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def _files(run_dir: Path) -> set:
    return {str(p.relative_to(run_dir)) for p in run_dir.rglob("*")
            if p.is_file() and "logs" not in p.parts}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    write_synthetic_stl10(root / "data", num_train=60, num_test=40, num_unlabeled=120, seed=1)
    mp = pytest.MonkeyPatch()
    mp.setenv("SSRL_DATA_DIR", str(root / "data"))
    mp.setenv("SSRL_TORCH_DEVICE", "cpu")
    yield {"root": root, "cfg": _write_cfg(root, "tiny.yaml"), "out": root / "outputs"}
    mp.undo()


@pytest.fixture(scope="module")
def mae_run(env):
    """pretrain_mae, then train_mae from its best.ckpt: the chain's outputs."""
    cfg = str(env["cfg"])
    t_pretrain_mae.main(["--config", cfg, "--output_dir_suffix", "mae_t"])
    pre = env["out"] / "pretrain" / "mae_t"
    probe = t_train_mae.main(["--config", cfg, "--encoder_ckpt",
                              str(pre / "checkpoints" / "best.ckpt"),
                              "--output_dir_suffix", "mae_t_400_frozen"])
    return {"pre": pre, "probe": env["out"] / "train" / "mae_t_400_frozen",
            "probe_trainer": probe}


def test_pretrain_then_probe_writes_the_cli_layout(env, mae_run):
    pre, probe = mae_run["pre"], mae_run["probe"]
    assert _files(pre) == RUN_FILES | {"vit-mae.pt"}
    assert _files(probe) == RUN_FILES | {"vit-mae.pt"}
    metrics = [json.loads(x) for x in (pre / "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m["val_loss"]) and m["mask_ratio"] == 0.75 for m in metrics)
    cls = [json.loads(x) for x in (probe / "metrics.jsonl").read_text().splitlines()]
    assert all(0.0 <= m["val_acc"] <= 1.0 for m in cls)
    snap = yaml.safe_load((pre / "config.yaml").read_text())
    assert snap["model"] == {**MODEL, "head": {**MODEL["head"]}}


@pytest.mark.parametrize("cli", ["pretrain_mae", "pretrain_jepa", "train_mae"])
def test_training_clis_take_their_route_from_the_environment(env, monkeypatch, cli):
    """``SSRL_TORCH_ATTN_IMPL`` picks the route of a training CLI's blocks:
    the kernels (``auto``) unless set, plain PyTorch with ``xla``, and an
    unknown name is refused."""
    monkeypatch.delenv(t_utils.ATTN_IMPL_ENV, raising=False)
    assert t_utils.attn_impl() == "auto"
    monkeypatch.setenv(t_utils.ATTN_IMPL_ENV, "kernels")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        t_utils.attn_impl()
    monkeypatch.setenv(t_utils.ATTN_IMPL_ENV, "xla")
    cfg = _write_cfg(env["root"], f"tiny_{cli}_xla.yaml", pretrain={"total_epochs": 1},
                     jepa={"total_epochs": 1}, train={"total_epochs": 1})
    cli_main = {"pretrain_mae": t_pretrain_mae, "pretrain_jepa": t_pretrain_jepa,
                "train_mae": t_train_mae}[cli].main
    trainer = cli_main(["--config", str(cfg), "--output_dir_suffix", f"{cli}_xla"])
    impls = {m.attn_impl for m in trainer.task.model.modules() if hasattr(m, "attn_impl")}
    assert impls == {"xla"}


def test_resume_goes_on_from_the_saved_epoch(env, mae_run, capsys):
    last = mae_run["pre"] / "checkpoints" / "last.ckpt"
    cfg = _write_cfg(env["root"], "tiny_3ep.yaml", pretrain={"total_epochs": 3})
    trainer = t_pretrain_mae.main(["--config", str(cfg), "--output_dir_suffix", "mae_t_r",
                                   "--resume_from", str(last)])
    assert "Resumed from" in capsys.readouterr().out
    run = env["out"] / "pretrain" / "mae_t_r"
    assert [json.loads(x)["epoch"] for x in (run / "metrics.jsonl").read_text().splitlines()] \
        == [2]
    assert trainer.global_step == 3 * 7  # 108 train images at B=16, padded: 7 steps


def test_probe_keeps_the_loaded_encoder_frozen(mae_run):
    """Under freeze_encoder the probe's encoder is the pretrained one, bit
    for bit, after training; only the head trained."""
    enc, report = t_encoder(mae_run["pre"] / "checkpoints" / "best.ckpt", 2)
    assert report["missing"] == []
    model = mae_run["probe_trainer"].task.model
    for k, v in enc.items():
        assert torch.equal(model.state_dict()[f"encoder.{k}"], v), k


def test_classifier_continuation_and_pt_encoder(env, mae_run, capsys):
    cfg = str(env["cfg"])
    t_train_mae.main(["--config", cfg, "--classifier_ckpt",
                      str(mae_run["probe"] / "checkpoints" / "best.ckpt"),
                      "--output_dir_suffix", "mae_t_400_full"])
    assert "full classifier checkpoint" in capsys.readouterr().out
    t_train_mae.main(["--config", cfg, "--encoder_ckpt", str(mae_run["pre"] / "vit-mae.pt"),
                      "--output_dir_suffix", "mae_t_400_pt"])
    assert "Training complete" in capsys.readouterr().out
    for suffix in ("mae_t_400_full", "mae_t_400_pt"):
        assert _files(env["out"] / "train" / suffix) == RUN_FILES | {"vit-mae.pt"}


def test_baseline_is_random_init(env, capsys):
    cfg = _write_cfg(env["root"], "tiny_1ep.yaml", train={"total_epochs": 1})
    t_train_mae.main(["--config", str(cfg), "--output_dir_suffix", "mae_000_4"])
    assert "Baseline: random-initialized" in capsys.readouterr().out


def test_evaluate_classifier_cli(env, mae_run, capsys):
    acc = t_eval.main(["--config", str(env["cfg"]), "--checkpoint",
                       str(mae_run["probe"] / "checkpoints" / "best.ckpt")])
    out = capsys.readouterr().out
    assert "Test Accuracy" in out and "Test Top-5 Accuracy" in out
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("present", [(), ("mae_finetune",), ("default",),
                                     ("default", "mae_finetune")])
def test_default_checkpoint_matches_the_jax_cli(tmp_path, present):
    from scripts.evaluation.evaluate_classifier import default_checkpoint as j_default

    for suffix in present:
        p = tmp_path / "train" / suffix / "checkpoints" / "best.ckpt"
        p.parent.mkdir(parents=True)
        p.touch()
    cfg = {"logging": {"output_dir_base": str(tmp_path)}, "train": {}}
    assert t_eval.default_checkpoint(cfg) == j_default(cfg)


def test_evaluate_checkpoint_through_both_packages(env, mae_run):
    """The probe's best.ckpt scored by both packages' ``evaluate_checkpoint``
    on the 40 test images (bf16 forward on both sides): test_acc within one
    image, which a bf16 rounding difference near a decision boundary may
    flip."""
    from scripts.utils import evaluate_checkpoint as j_evaluate

    cfg = yaml.safe_load(env["cfg"].read_text())
    ckpt = mae_run["probe"] / "checkpoints" / "best.ckpt"
    data = env["root"] / "data"
    acc_t = t_utils.evaluate_checkpoint(cfg, ckpt, t_loaders.get_test_dataloader(cfg, data))
    acc_j = j_evaluate(cfg, ckpt, j_loaders.get_test_dataloader(cfg, data))
    assert abs(acc_t - float(acc_j)) <= 1 / 40 + 1e-6


def test_jepa_then_probe_from_vit_jepa_pt(env, capsys):
    cfg = str(env["cfg"])
    trainer = t_pretrain_jepa.main(["--config", cfg, "--output_dir_suffix", "jepa_t"])
    run = env["out"] / "pretrain" / "jepa_t"
    assert _files(run) == RUN_FILES | {"vit-jepa.pt", "jepa_state.ckpt"}
    assert "JEPA pretraining complete" in capsys.readouterr().out
    state = torch.load(run / "vit-jepa.pt", weights_only=True)
    assert "cls_token" in state and "blocks.0.attn.qkv.weight" in state
    model = trainer.task.model.state_dict()
    assert set(state) == {k[len("encoder."):] for k in model if k.startswith("encoder.")}
    full = torch.load(run / "jepa_state.ckpt", weights_only=False)
    assert set(full["extra"]) == set(state)  # the EMA target, by the encoder's names
    assert all(torch.equal(full["state_dict"][f"model.{k}"], v) for k, v in model.items())
    t_train_mae.main(["--config", cfg, "--encoder_ckpt", str(run / "vit-jepa.pt"),
                      "--output_dir_suffix", "jepa_t_400_frozen"])
    assert "Training complete" in capsys.readouterr().out


def test_port_exports_equal_the_jax_export(env, mae_run, tmp_path):
    """vit-mae.pt (MAE) and the probe's vit-mae.pt (classifier) as the JAX
    package's ``export_reference_weights`` writes them from the same
    parameters: key set and every tensor bit for bit; the port's vit-mae.pt
    loads through the JAX package's ``encoder_params_from_checkpoint``."""
    cases = [(mae_run["pre"] / "vit-mae.pt",
              lambda s: ti.mae_state_to_params(s, 2, 1)[0]),
             (mae_run["probe"] / "vit-mae.pt",
              lambda s: ti.classifier_state_to_params(s, 2)[0])]
    for path, to_params in cases:
        mine = torch.load(path, weights_only=True)
        want_path = tmp_path / path.parent.name
        assert ti.export_reference_weights(want_path, to_params(ti.load_torch_state_dict(path)))
        want = torch.load(want_path, weights_only=True)
        assert set(mine) == set(want)
        for k, v in want.items():
            assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
    enc, report = j_load.encoder_params_from_checkpoint(mae_run["pre"] / "vit-mae.pt", 2)
    assert report["missing"] == [] and "blocks_1" in enc


def test_vit_jepa_pt_equals_the_jax_encoder_export(env, tmp_path):
    """The JEPA CLI's bare timm encoder, through the JAX package's importer
    and exporter, is the same file; the JAX package's own
    ``encoder_params_from_checkpoint`` refuses that layout (no encoder
    prefix), which is why the port's loader also takes a bare timm ViT."""
    path = env["out"] / "pretrain" / "jepa_t" / "vit-jepa.pt"
    if not path.exists():
        t_pretrain_jepa.main(["--config", str(env["cfg"]), "--output_dir_suffix", "jepa_t"])
    params, report = ti.timm_vit_to_params(ti.load_torch_state_dict(path), 2)
    assert report["missing"] == []
    assert ti.export_reference_weights(tmp_path / "j.pt", {"encoder": params})
    mine, want = torch.load(path, weights_only=True), torch.load(tmp_path / "j.pt",
                                                                 weights_only=True)
    assert set(mine) == set(want)
    assert all(torch.equal(mine[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="Could not find encoder weights"):
        j_load.encoder_params_from_checkpoint(path, 2)


def test_jax_export_trains_in_the_port(env, tmp_path):
    """A JAX ``export_reference_weights`` MAE file as ``--encoder_ckpt``: the
    frozen probe's encoder is the exported one, bit for bit."""
    from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
    from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_to_state

    model = mae_from_config(MODEL)
    model.init_weights(torch.Generator().manual_seed(5))
    params, _ = ti.mae_state_to_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, 2, 1)
    path = tmp_path / "jax-vit-mae.pt"
    assert ti.export_reference_weights(path, params)
    cfg = _write_cfg(env["root"], "tiny_1ep_probe.yaml", train={"total_epochs": 1})
    trainer = t_train_mae.main(["--config", str(cfg), "--encoder_ckpt", str(path),
                                "--output_dir_suffix", "from_jax"])
    want = mae_params_to_state(params)
    got = trainer.task.model.state_dict()
    for k, v in want.items():
        if k.startswith("encoder.vit."):
            assert torch.equal(got["encoder." + k[len("encoder.vit."):]],
                               torch.from_numpy(v)), k


def test_jax_native_checkpoint_trains_in_the_port(env, tmp_path):
    """A JAX-native MAE checkpoint (flax msgpack in a zip, the JAX trainer's
    format) as ``--encoder_ckpt``: the probe's encoder is the file's, bit
    for bit, as the JAX CLI takes it."""
    from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
    from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_to_state
    from ssrl_vit_mae_jepa_tpu.utils.checkpoint import save_checkpoint

    model = mae_from_config(MODEL)
    model.init_weights(torch.Generator().manual_seed(6))
    params, _ = ti.mae_state_to_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, 2, 1)
    path = save_checkpoint(tmp_path / "native-mae.ckpt", {"params": params}, {"epoch": 1})
    jenc, _ = j_load.encoder_params_from_checkpoint(path, 2)  # the JAX CLI's reader takes it
    cfg = _write_cfg(env["root"], "tiny_1ep_native.yaml", train={"total_epochs": 1})
    trainer = t_train_mae.main(["--config", str(cfg), "--encoder_ckpt", str(path),
                                "--output_dir_suffix", "from_native"])
    got = trainer.task.model.state_dict()
    want = ti.vit_params_to_timm_state(jenc)
    for k, v in want.items():
        assert torch.equal(got["encoder." + k], torch.from_numpy(v.copy())), k
    assert set(want) == {k[len("encoder.vit."):] for k in mae_params_to_state(params)
                         if k.startswith("encoder.vit.")}


def test_step_records_and_periodic_files_match_the_jax_trainer(env, tmp_path):
    """log_every_n_steps=3, periodic_ckpt_every=1, 2 epochs of MAE: the same
    records (step, epoch, metric names) and checkpoint files as the JAX
    Trainer at the same settings."""
    from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
    from ssrl_vit_mae_jepa_tpu.training.trainer import Trainer as JTrainer

    cfg = {"pretrain": PRETRAIN, "seed": 73}
    data = env["root"] / "data"
    settings = dict(log_every_n_steps=3, periodic_ckpt_every=1)
    jt = JTrainer(JMAETask(MODEL, PRETRAIN), 2, tmp_path / "jax", **settings)
    jt.fit(*j_loaders.get_pretrain_dataloaders(cfg, data))
    tt = Trainer(MAETask(MODEL, PRETRAIN, device="cpu"), 2, tmp_path / "port", **settings)
    tt.fit(*t_loaders.get_pretrain_dataloaders(cfg, data))

    def records(run):
        lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        return [(r["step"], r["epoch"], sorted(set(r) - {"step", "epoch", "time"}))
                for r in lines]

    got, want = records(tmp_path / "port"), records(tmp_path / "jax")
    assert got == want
    assert [r[0] for r in got if r[2] == ["train_loss"]] == [3, 6, 9, 12]
    names = lambda run: sorted(p.name for p in (run / "checkpoints").iterdir())  # noqa: E731
    assert names(tmp_path / "port") == names(tmp_path / "jax") == [
        "best.ckpt", "epoch-000.ckpt", "epoch-001.ckpt", "last.ckpt"]
    periodic = torch.load(tmp_path / "port" / "checkpoints" / "epoch-001.ckpt",
                          weights_only=False)
    assert periodic["weights_only"] and "optimizer" not in periodic


# (config's train section) -> the policy scripts/training/train_mae.py picks
FREEZE_CASES = {
    "unfreeze1_over_freeze": {"unfreeze_last_layers": 1, "freeze_encoder": True},
    "unfreeze2_unfrozen": {"unfreeze_last_layers": 2, "freeze_encoder": False},
    "freeze": {"freeze_encoder": True},
    "unfreeze": {"freeze_encoder": False},
    "default": {},
}


def _jax_cli_policy(monkeypatch, tmp_path, train_cfg):
    """The (freeze_encoder, unfreeze_last_layers) that the JAX package's
    train_mae CLI sets on its task for this train section: its main() runs
    up to the Trainer, which is stubbed to capture the task."""
    import scripts.training.train_mae as j_cli
    import ssrl_vit_mae_jepa_tpu.training.trainer as j_trainer

    seen = {}

    class Stop(Exception):
        pass

    def stub(task, **kwargs):
        seen["policy"] = (task._freeze_encoder, task._unfreeze_last)
        raise Stop

    cfg = _write_cfg(tmp_path, "freeze.yaml")
    raw = yaml.safe_load(cfg.read_text())
    raw["train"] = {k: v for k, v in raw["train"].items() if k != "freeze_encoder"}
    raw["train"].update(train_cfg)
    cfg.write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(j_trainer, "Trainer", stub)
    monkeypatch.setattr(j_loaders, "get_train_dataloaders", lambda cfg: (None, None))
    monkeypatch.setattr(sys, "argv", ["train_mae", "--config", str(cfg)])
    with pytest.raises(Stop):
        j_cli.main()
    return seen["policy"], cfg


@pytest.mark.parametrize("case", list(FREEZE_CASES))
def test_freeze_precedence_matches_the_jax_cli(monkeypatch, tmp_path, case):
    """The config's train section as both CLIs read it (over the defaults,
    whose freeze_encoder is False): the same policy and trainable set."""
    from ssrl_vit_mae_jepa_torch.config import load_config

    (fe, un), cfg_path = _jax_cli_policy(monkeypatch, tmp_path, FREEZE_CASES[case])
    train_cfg = load_config(cfg_path)["train"]
    task = ClassifierTask(MODEL, train_cfg, device="cpu")
    t_train_mae.apply_freeze_policy(task, train_cfg)
    assert (task._freeze_encoder, task._unfreeze_last) == (fe, un)
    task.init_state(0)
    params = ti.classifier_state_to_params(
        {k: v.detach().numpy() for k, v in task.model.state_dict().items()}, 2)[0]
    jmask = j_trainable_mask(params, freeze_encoder=fe, unfreeze_last_layers=un, depth=2)
    full = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in classifier_params_to_state(full).items()}
    assert task.mask == want


def test_orbax_backend_is_refused(env):
    cfg = _write_cfg(env["root"], "tiny_orbax.yaml", logging={"ckpt_backend": "orbax"})
    for cli in (t_pretrain_mae, t_train_mae, t_pretrain_jepa):
        with pytest.raises(ValueError, match="orbax"):
            cli.main(["--config", str(cfg), "--output_dir_suffix", "orb"])
    assert not (env["out"] / "pretrain" / "orb").exists()


def test_synthetic_data_cli(tmp_path):
    from ssrl_vit_mae_jepa_torch.scripts import data as t_data

    t_data.main(["--synthetic", "--data_dir", str(tmp_path / "d"), "--synthetic_train", "20",
                 "--synthetic_test", "10", "--synthetic_unlabeled", "30"])
    assert (tmp_path / "d/stl10_binary/unlabeled_X.bin").exists()


# ---------------------------------------------------------------------------
# Ablation drivers: the launched commands against the JAX drivers'
# ---------------------------------------------------------------------------

def _run_driver(driver, monkeypatch, root: Path, env_vars: dict, fail: set, seed_ckpts):
    """Run ``driver.main`` in ``root`` with ``subprocess.run`` recording each
    command; a launched run writes its best.ckpt unless its suffix is in
    ``fail``, where it exits 1. Returns the commands (``root`` made ``<R>``),
    the configs written and the sweep's SystemExit message, if any."""
    root.mkdir()
    cfg = _write_cfg(root, "base.yaml")
    out = root / "outputs"
    for rel in seed_ckpts:
        (out / rel / "checkpoints").mkdir(parents=True, exist_ok=True)
        (out / rel / "checkpoints" / "best.ckpt").touch()
    launched = []

    def fake_run(cmd, *args, **kwargs):
        module, suffix = cmd[2], cmd[cmd.index("--output_dir_suffix") + 1]
        kind = "pretrain" if module.endswith("pretrain_mae") else "train"
        launched.append([str(c).replace(str(root), "<R>") for c in cmd[1:]])
        if suffix in fail:
            return subprocess.CompletedProcess(cmd, 1)
        best = out / kind / suffix / "checkpoints" / "best.ckpt"
        best.parent.mkdir(parents=True, exist_ok=True)
        best.touch()
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.chdir(root)
    monkeypatch.setenv("SSRL_ABLATION_CONFIG", str(cfg))
    for k, v in env_vars.items():
        monkeypatch.setenv(k, v)
    with monkeypatch.context() as m:
        m.setattr(subprocess, "run", fake_run)
        try:  # the baseline sweep stops at a failed run with SystemExit
            driver.main([]) if driver.__name__.startswith("ssrl") else driver.main()
            stopped = None
        except SystemExit as e:
            stopped = str(e)
    written = sorted(str(p.relative_to(root)) for p in root.rglob("*.yaml")
                     if p.name != "base.yaml")
    return launched, written, stopped


DRIVERS = {
    "pretrain": ({"SSRL_ABLATION_FRACTIONS": "0.25,0.5,1.0"}, {"mae_050"}, ["pretrain/mae_025"]),
    "train": ({"SSRL_ABLATION_FRACTIONS": "100,50", "SSRL_ABLATION_LABELS": "10,25"},
              {"mae_100_25_unfreeze1"},
              ["pretrain/mae_100", "train/mae_100_10_frozen"]),
    "baseline": ({"SSRL_ABLATION_LABELS": "10,25,50"}, {"mae_000_25"}, ["train/mae_000_50"]),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_ablation_driver_launches_the_jax_drivers_runs(monkeypatch, tmp_path, name):
    import scripts.ablation.run_baseline_ablation as j_base
    import scripts.ablation.run_pretrain_ablation as j_pre
    import scripts.ablation.run_train_ablation as j_train

    port = {"pretrain": t_pre, "train": t_train, "baseline": t_base}[name]
    jax_driver = {"pretrain": j_pre, "train": j_train, "baseline": j_base}[name]
    env_vars, fail, seeded = DRIVERS[name]
    got, got_cfgs, got_stop = _run_driver(port, monkeypatch, tmp_path / "port", env_vars, fail,
                                          seeded)
    want, want_cfgs, want_stop = _run_driver(jax_driver, monkeypatch, tmp_path / "jax",
                                             env_vars, fail, seeded)
    assert got and got_cfgs == want_cfgs and got_stop == want_stop
    jax_mod = "scripts.training."
    assert [c[0] for c in got] == ["-m"] * len(got)
    assert [c[1] for c in got] == [m.replace(jax_mod, "ssrl_vit_mae_jepa_torch." + jax_mod)
                                   for _, m, *_ in want]
    assert [c[2:] for c in got] == [c[2:] for c in want]


def test_profiling_copy_matches_the_jax_module(monkeypatch, tmp_path):
    """``StepTimer`` gives the JAX timer's rolling mean from the same clock;
    ``trace`` writes a ``torch.profiler`` trace (and is a no-op for None)."""
    import time

    from ssrl_vit_mae_jepa_torch.utils import profiling as t_prof
    from ssrl_vit_mae_jepa_tpu.utils import profiling as j_prof

    means = []
    for mod in (t_prof, j_prof):
        clock = iter([0.0, 1.0, 3.0, 6.0, 10.0, 15.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=3)
        assert timer.mean_step_s == 0.0
        for _ in range(6):
            timer.tick()
        means.append(timer.mean_step_s)
    monkeypatch.undo()
    assert means[0] == means[1] == 4.0
    with t_prof.trace(None):
        pass
    with t_prof.trace(tmp_path / "trace"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
