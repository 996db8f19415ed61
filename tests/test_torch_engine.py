"""The port's engine and data path against the JAX package, on the CPU.

The synthetic STL-10 writer (byte for byte), the split indices and the
``HostLoader`` batches of the three loader factories, the host gather,
checkpoints (a round trip of the whole train state; a port checkpoint read
by the JAX package's ``utils/load.py``; a JAX ``export_reference_weights``
file read by the port), ``CheckpointCallbacks`` choosing the JAX package's
files, a two-epoch ``Trainer.fit`` of MAE and then of the classifier from
its ``best.ckpt``, a resume that equals an uninterrupted run bit for bit,
and an empty eval loader.

Toy geometry: 96 px, patch 8, encoder 48/2/4, decoder 32/1/4, f32.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.data import loaders as t_loaders
from ssrl_vit_mae_jepa_torch.data import stl10 as t_stl10
from ssrl_vit_mae_jepa_torch.data.pipeline import HostLoader as THostLoader
from ssrl_vit_mae_jepa_torch.data.pipeline import device_prefetch
from ssrl_vit_mae_jepa_torch.runtime import native as t_native
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.optim import AdamW
from ssrl_vit_mae_jepa_torch.training.state import TrainState
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
from ssrl_vit_mae_jepa_torch.utils import checkpoint as t_ckpt
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_torch.utils import load as t_load
from ssrl_vit_mae_jepa_tpu.data import loaders as j_loaders
from ssrl_vit_mae_jepa_tpu.data import stl10 as j_stl10
from ssrl_vit_mae_jepa_tpu.utils import load as j_load
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti
from ssrl_vit_mae_jepa_tpu.utils.checkpoint import CheckpointCallbacks as JCallbacks

GENERAL = {"image_size": 96, "patch_size": 8, "in_chans": 3}
ENCODER = {"embed_dim": 48, "depth": 2, "num_heads": 4}
MODEL = {"general": GENERAL, "encoder": ENCODER, "head": {"pool": "cls"},
         "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4}}
CFG = {
    "seed": 73,
    "pretrain": {"mask_ratio_start": 0.5, "mask_ratio_end": 0.75, "mask_ramp_epochs": 3,
                 "total_epochs": 4, "warmup_epochs": 1, "batch_size": 8,
                 "base_learning_rate": 1e-3, "weight_decay": 0.05, "data_fraction": 0.8,
                 "val_split": 0.2},
    "train": {"samples_per_class": 3, "total_epochs": 4, "warmup_epochs": 1, "batch_size": 8,
              "learning_rate": 1e-3, "weight_decay": 0.05, "freeze_encoder": False},
    "test": {"batch_size": 8},
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("stl10")
    t_stl10.write_synthetic_stl10(root, num_train=50, num_test=20, num_unlabeled=45, seed=3)
    return root


@pytest.mark.parametrize("signal", ["linear", "texture"])
def test_synthetic_writer_is_byte_identical(tmp_path, signal):
    t_stl10.write_synthetic_stl10(tmp_path / "t", 30, 20, 25, seed=1, class_signal=signal)
    j_stl10.write_synthetic_stl10(tmp_path / "j", 30, 20, 25, seed=1, class_signal=signal)
    names = sorted(p.name for p in (tmp_path / "j" / "stl10_binary").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t" / "stl10_binary").iterdir())
    for n in names:
        assert ((tmp_path / "t" / "stl10_binary" / n).read_bytes()
                == (tmp_path / "j" / "stl10_binary" / n).read_bytes()), n


def test_split_indices_match():
    labels = np.random.default_rng(0).integers(0, 10, 300)
    for a, b in zip(t_stl10.stratified_split_indices(labels, 7, 73),
                    j_stl10.stratified_split_indices(labels, 7, 73)):
        assert np.array_equal(a, b)
    for a, b in zip(t_stl10.pretrain_split_indices(1000, 0.5, 0.06, 73),
                    j_stl10.pretrain_split_indices(1000, 0.5, 0.06, 73)):
        assert np.array_equal(a, b)
    assert np.array_equal(t_stl10.subset_first_n(90, 0.3), j_stl10.subset_first_n(90, 0.3))


def _same_epochs(tl, jl, epochs=(0, 1)):
    assert len(tl) == len(jl) and tl.num_examples == jl.num_examples
    assert tl.prefetch_depth == jl.prefetch_depth
    for e in epochs:
        tb, jb = list(tl.epoch(e)), list(jl.epoch(e))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert set(a) == set(b) == {"image", "label", "weight"}
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_loaders_give_the_jax_packages_batches(data):
    """Pretrain (shuffled, with a padded last batch), labeled (stratified)
    and test loaders: the same indices and the same batches per epoch."""
    tl, jl = t_loaders.get_pretrain_dataloaders(CFG, data), j_loaders.get_pretrain_dataloaders(
        CFG, data)
    assert tl[0].num_examples % 8  # the last batch is padded
    for a, b in zip(tl, jl):
        assert np.array_equal(a.indices, b.indices)
        _same_epochs(a, b)
    for a, b in zip(t_loaders.get_train_dataloaders(CFG, data),
                    j_loaders.get_train_dataloaders(CFG, data)):
        assert np.array_equal(a.indices, b.indices)
        _same_epochs(a, b)
    _same_epochs(t_loaders.get_test_dataloader(CFG, data),
                 j_loaders.get_test_dataloader(CFG, data), epochs=(0,))
    last = list(tl[0].epoch(1))[-1]
    n_real = tl[0].num_examples % 8
    assert last["weight"].tolist() == [1.0] * n_real + [0.0] * (8 - n_real)


def test_prefetch_hands_over_every_batch_on_the_cpu(data):
    loader, _ = t_loaders.get_pretrain_dataloaders(CFG, data)
    got = list(device_prefetch(loader.epoch(2), "cpu", depth=2))
    want = list(loader.epoch(2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(a[k], torch.from_numpy(b[k])) for k in b)
    # a consumer that stops early releases the worker
    it = device_prefetch(loader.epoch(0), "cpu", depth=1)
    next(it)
    it.close()


def test_native_gather_matches_numpy(data):
    ds = t_stl10.STL10(data, split="unlabeled")
    idx = np.array([4, 0, 44, 4, 17])
    want = np.ascontiguousarray(np.asarray(ds._raw[idx]).transpose(0, 3, 2, 1))
    assert t_native.native_available()  # g++ builds it into build/native
    assert np.array_equal(t_native.gather_nhwc(ds._raw, idx), want)
    with pytest.raises(IndexError):
        t_native.gather_nhwc(ds._raw, np.array([45]))


def test_disable_native_forces_the_numpy_gather(data, monkeypatch):
    """``SSRL_DISABLE_NATIVE=1`` skips the library, as in the JAX package."""
    monkeypatch.setenv("SSRL_DISABLE_NATIVE", "1")
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    monkeypatch.setattr(t_native, "_build", lambda so: pytest.fail("built"))
    ds = t_stl10.STL10(data, split="unlabeled")
    idx = np.array([4, 0, 44, 4, 17])
    want = np.ascontiguousarray(np.asarray(ds._raw[idx]).transpose(0, 3, 2, 1))
    assert not t_native.native_available()
    got = t_native.gather_nhwc(ds._raw, idx)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def _jepa_task():
    cfg = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 4, "base_learning_rate": 1e-2,
           "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4}
    return TJEPATask({"general": GENERAL, "encoder": ENCODER}, cfg, dtype=torch.float32,
                     device="cpu")


def test_checkpoint_round_trip(tmp_path):
    """Params, moments, count, lr, generator, the EMA extra and the step
    come back bit for bit into a fresh task."""
    task = _jepa_task()
    state = task.init_state(0)
    images = np.random.default_rng(0).integers(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    batch = {"image": torch.from_numpy(images), "weight": torch.ones(4)}
    for _ in range(2):
        state, _ = task.train_step(state, batch, 1)
    path = t_ckpt.save_checkpoint(tmp_path / "x.ckpt",
                                  t_ckpt.state_payload(state, task.model.state_dict(), task.tx),
                                  {"epoch": 1, "global_step": 2})
    fresh = _jepa_task()
    new = fresh.init_state(1)
    t_ckpt.restore_state(t_ckpt.load_checkpoint(path), new, fresh.model, fresh.tx)
    for k, v in state.params.items():
        assert torch.equal(new.params[k], v), k
    for a, b in zip(new.opt_state.mu + new.opt_state.nu, state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)
    assert (new.opt_state.count, new.step) == (state.opt_state.count, state.step) == (2, 2)
    assert new.opt_state.learning_rate == state.opt_state.learning_rate
    assert torch.equal(new.generator.get_state(), state.generator.get_state())
    assert all(torch.equal(new.extra[k], v) for k, v in state.extra.items())
    # the next step of both is the same
    s1, _ = task.train_step(state, batch, 1)
    s2, _ = fresh.train_step(new, batch, 1)
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)


def _classifier_task():
    return ClassifierTask(MODEL, CFG["train"], dtype=torch.float32, device="cpu")


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    """The JAX package's loaders read a port checkpoint (MAE and
    classifier) to the port's weights."""
    cls = _classifier_task()
    cstate = cls.init_state(0)
    cpath = t_ckpt.save_checkpoint(tmp_path / "c.ckpt",
                                   t_ckpt.state_payload(cstate, cls.model.state_dict(), cls.tx))
    params, report, _ = j_load.classifier_params_from_checkpoint(cpath, depth=2)
    assert report["missing"] == []
    got = interop.classifier_params_to_state(params)
    want = {k: v.numpy() for k, v in cls.model.state_dict().items()}
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)

    mae = MAETask(MODEL, CFG["pretrain"], dtype=torch.float32, device="cpu")
    mstate = mae.init_state(0)
    mpath = t_ckpt.save_checkpoint(tmp_path / "m.ckpt",
                                   t_ckpt.state_payload(mstate, mae.model.state_dict(), mae.tx))
    enc, report = j_load.encoder_params_from_checkpoint(mpath, depth=2)
    assert report["missing"] == [] and report["unexpected"] == ["mask_token"]
    got = interop.vit_params_to_state(enc)
    for k, v in got.items():
        assert np.array_equal(v, mae.model.encoder.vit.state_dict()[k].numpy()), k
    # and the port's own loader gives the same encoder
    tenc, treport = t_load.encoder_params_from_checkpoint(mpath, depth=2)
    assert treport == report
    assert all(np.array_equal(tenc[k].numpy(), v) for k, v in got.items())
    full, _ = t_load.mae_params_from_checkpoint(mpath, depth=2, decoder_depth=1)
    MAETask(MODEL, CFG["pretrain"], dtype=torch.float32, device="cpu").model.load_state_dict(
        full, strict=True)


def test_jax_export_loads_in_the_port(tmp_path):
    """A JAX ``export_reference_weights`` classifier file, through the
    port's loader, strict into the port's ``ViTClassifier``."""
    src = _classifier_task()
    src.init_state(3)
    params, _ = ti.classifier_state_to_params(
        {k: v.numpy() for k, v in src.model.state_dict().items()}, depth=2)
    params = jax.tree.map(lambda a: np.asarray(a) * 1.5, params)
    path = tmp_path / "export.pt"
    assert ti.export_reference_weights(path, params)
    state, report, _ = t_load.classifier_params_from_checkpoint(path, depth=2)
    assert report == {"missing": [], "unexpected": []}
    dst = _classifier_task()
    dst.model.load_state_dict(state, strict=True)
    want = ti.classifier_params_to_state(params)
    assert all(np.array_equal(dst.model.state_dict()[k].numpy(), v) for k, v in want.items())


def test_jax_native_checkpoint_is_refused_with_the_converter(tmp_path):
    """A JAX-native checkpoint (flax msgpack in a zip) needs no converter:
    ``load_any`` reads it and returns the JAX export's weights
    (``tests/test_torch_native_ckpt.py`` holds every kind)."""
    from ssrl_vit_mae_jepa_tpu.utils.checkpoint import save_checkpoint

    src = _classifier_task()
    src.init_state(3)
    params, _ = ti.classifier_state_to_params(
        {k: v.numpy() for k, v in src.model.state_dict().items()}, depth=2)
    path = save_checkpoint(tmp_path / "n.ckpt", {"params": params})
    kind, state, meta = t_load.load_any(path)
    assert kind == "native" and meta["__format__"] == "ssrl_vit_mae_jepa_tpu"
    want = ti.classifier_params_to_state(params)
    assert set(state) == set(want)
    assert all(np.array_equal(state[k].numpy(), v) for k, v in want.items())


def test_merge_encoder_checks_shapes():
    cls = _classifier_task()
    cls.init_state(0)
    params = cls.model.state_dict()
    enc = {k[len("encoder."):]: torch.ones_like(v) for k, v in params.items()
           if k.startswith("encoder.")}
    merged = t_load.merge_encoder(params, enc)
    assert all(torch.equal(merged[f"encoder.{k}"], v) for k, v in enc.items())
    assert torch.equal(merged["head.classification.weight"], params["head.classification.weight"])
    enc["cls_token"] = torch.ones(1, 1, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_load.merge_encoder(params, enc)


@pytest.mark.parametrize("mode,scores", [("min", [0.9, 0.7, 0.8, 0.6, 0.6]),
                                         ("max", [0.1, 0.3, 0.2, 0.3, 0.5])])
def test_callbacks_choose_the_jax_packages_files(tmp_path, mode, scores):
    """best / last / periodic (every 2 epochs) on a fixed metric sequence:
    the same files each epoch and the same best score as the JAX policy."""
    jcb = JCallbacks(tmp_path / "j", monitor="val_m", mode=mode, periodic_every=2)
    tcb = t_ckpt.CheckpointCallbacks(tmp_path / "t", monitor="val_m", mode=mode,
                                     periodic_every=2)
    w = torch.zeros(2, requires_grad=True)
    tx = AdamW(1e-3, 0.0)
    tstate = TrainState({"w": w}, tx.init({"w": w}), torch.Generator())
    for epoch, score in enumerate(scores):
        m = {"val_m": score}
        js = jcb.on_epoch_end(epoch, m, {"params": {"w": np.zeros(2, np.float32)}},
                              meta_base={"global_step": epoch})
        ts = tcb.on_epoch_end(epoch, m, t_ckpt.state_payload(tstate, {"w": w.detach()}, tx),
                              {"global_step": epoch})
        assert [p.name for p in ts["saved"]] == [p.name for p in js["saved"]], epoch
        assert tcb.best_score == jcb.best_score
    best = t_ckpt.load_checkpoint(tmp_path / "t" / "best.ckpt")
    assert best["callbacks"]["best_model_score"] == jcb.best_score
    assert t_ckpt.load_checkpoint(tmp_path / "t" / "epoch-003.ckpt")["weights_only"]


def _fit(tmp, data, epochs, name, resume=None, max_epochs=None):
    task = MAETask(MODEL, CFG["pretrain"], dtype=torch.float32, device="cpu")
    trainer = Trainer(task, max_epochs or epochs, tmp / name, hyper_parameters=CFG)
    train, val = t_loaders.get_pretrain_dataloaders(CFG, data)
    metrics = trainer.fit(train, val, resume_from=resume)
    return trainer, metrics


def test_fit_mae_then_the_classifier_from_its_best_checkpoint(tmp_path, data):
    mae, m = _fit(tmp_path, data, 2, "mae")
    ckpts = tmp_path / "mae" / "checkpoints"
    assert {p.name for p in ckpts.iterdir()} == {"best.ckpt", "last.ckpt"}
    lines = [json.loads(x) for x in (tmp_path / "mae" / "metrics.jsonl").read_text().split("\n")
             if x]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert lines[1]["mask_ratio"] == 0.625 and np.isfinite(lines[1]["val_loss"])
    assert m["images_per_s"] > 0 and mae.global_step == 2 * 4  # 29 train images, B=8
    # save() writes the state that the last epoch's last.ckpt holds
    saved = t_ckpt.load_checkpoint(mae.save(tmp_path / "mae.ckpt"))
    last = t_ckpt.load_checkpoint(ckpts / "last.ckpt")
    assert saved["global_step"] == last["global_step"] == 8
    assert all(torch.equal(v, last["state_dict"][k]) for k, v in saved["state_dict"].items())
    assert torch.equal(saved["generator"]["state"], last["generator"]["state"])
    assert all(torch.equal(v, last["optimizer"]["mu"][k])
               for k, v in saved["optimizer"]["mu"].items())
    enc, report = t_load.encoder_params_from_checkpoint(ckpts / "best.ckpt", depth=2)
    assert report["missing"] == []
    cls = Trainer(_classifier_task(), 2, tmp_path / "cls")
    train, val = t_loaders.get_train_dataloaders(CFG, data)
    cls.fit(train, val, init_params_override=lambda p: t_load.merge_encoder(p, enc))
    assert {p.name for p in (tmp_path / "cls" / "checkpoints").iterdir()} == {
        "best.ckpt", "last.ckpt"}
    best = t_ckpt.load_checkpoint(tmp_path / "cls" / "checkpoints" / "best.ckpt")
    assert best["callbacks"]["monitor"] == "val_acc" and best["callbacks"]["mode"] == "max"
    test = cls.test(t_loaders.get_test_dataloader(CFG, data))
    assert set(test) == {"test_loss", "test_acc", "test_top5"}
    assert 0.0 <= test["test_acc"] <= 1.0 and np.isfinite(test["test_loss"])
    # test(params) loads a state dict first, with fresh optimizer state
    other = {k: v * 0.5 for k, v in t_ckpt.model_state(best).items()}
    test = cls.test(t_loaders.get_test_dataloader(CFG, data), params=other)
    assert np.isfinite(test["test_loss"]) and cls.state.opt_state.count == 0
    assert all(torch.equal(cls.state.params[k], other[k]) for k in cls.state.params)


def test_resume_equals_an_uninterrupted_run(tmp_path, data):
    """Two epochs straight, against one epoch, then a resume from its
    last.ckpt for the second: the same bits in every param and moment."""
    straight, m2 = _fit(tmp_path, data, 2, "straight")
    _fit(tmp_path, data, 1, "first")
    resumed, r2 = _fit(tmp_path, data, 1, "resumed", max_epochs=2,
                       resume=tmp_path / "first" / "checkpoints" / "last.ckpt")
    a, b = straight.state, resumed.state
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(torch.equal(x, y) for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                                                 b.opt_state.mu + b.opt_state.nu))
    assert (a.step, straight.global_step) == (b.step, resumed.global_step)
    assert {k: v for k, v in m2.items() if k not in ("epoch_time_s", "images_per_s")} == {
        k: v for k, v in r2.items() if k not in ("epoch_time_s", "images_per_s")}
    lines = (tmp_path / "resumed" / "metrics.jsonl").read_text().split("\n")
    assert [json.loads(x)["epoch"] for x in lines if x] == [1]


def test_empty_eval_loader_raises(tmp_path, data):
    trainer = Trainer(MAETask(MODEL, CFG["pretrain"], dtype=torch.float32, device="cpu"), 1,
                      tmp_path / "e")
    trainer.init_state()
    empty = THostLoader(t_stl10.STL10(data, split="unlabeled"), np.arange(0), 8, shuffle=False)
    with pytest.raises(ValueError, match="empty loader"):
        trainer.evaluate(empty)

