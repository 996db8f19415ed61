"""The port reads the JAX package's native checkpoints, on the CPU.

Tiny MAE, classifier and JEPA train states are made by the JAX tasks'
``init_state`` and written by the JAX package's own
``utils/checkpoint.py::save_checkpoint`` (a trainer ``.ckpt``) or as a
``{"params": ...}`` weights file, the layout ``extract_weights`` falls back
to. The port's ``utils/flax_msgpack.py`` decodes them bit for bit as
``flax.serialization.msgpack_restore`` does (a bf16 leaf and a chunked
array included); ``load_any`` and the three ``*_params_from_checkpoint``
give the weights of the JAX package's own export (``utils/torch_interop``);
the port's ``convert_to_torch`` writes the JAX CLI's file tensor for
tensor; a foreign ``__format__`` is refused.

Toy geometry: 96 px, patch 8, encoder 48/2/4, decoder 32/1/4, predictor
32/1/4.

``tests/fixtures/jax_native_classifier.ckpt`` is a JAX-native trainer
checkpoint of a classifier (encoder 48/1/4) that ``chip_smoke.py`` loads on
a machine without JAX or msgpack; ``python -m tests.test_torch_native_ckpt``
writes it anew, and a test holds the committed file to what the JAX package
writes now.
"""

import json
import pathlib
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from scripts.weight_utils import convert_to_torch as j_convert
from ssrl_vit_mae_jepa_torch.scripts.weight_utils import convert_to_torch as t_convert
from ssrl_vit_mae_jepa_torch.scripts.weight_utils import extract_weights as t_extract
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.utils import flax_msgpack
from ssrl_vit_mae_jepa_torch.utils import load as t_load
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import load as j_load
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti
from ssrl_vit_mae_jepa_tpu.utils.checkpoint import save_checkpoint

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "jax_native_classifier.ckpt"
FIXTURE_MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
                 "encoder": {"embed_dim": 48, "depth": 1, "num_heads": 4},
                 "head": {"pool": "cls"}}

MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
         "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
         "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
         "head": {"pool": "cls"}}
PRE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "total_epochs": 4,
           "warmup_epochs": 1, "batch_size": 8, "base_learning_rate": 1e-3}
TRAIN_CFG = {"learning_rate": 1e-3, "total_epochs": 4, "warmup_epochs": 1,
             "batch_size": 8, "freeze_encoder": False}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 8,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4}
DEPTH, DEC_DEPTH = 2, 1
KINDS = ("mae", "classifier", "jepa")


def _task(kind):
    if kind == "mae":
        return JMAETask(MODEL, PRE_CFG, dtype=jnp.float32)
    if kind == "classifier":
        return JClassifierTask(MODEL, TRAIN_CFG, dtype=jnp.float32)
    return JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def states():
    """kind → the JAX task's whole train state (params, Adam state, key,
    step, JEPA's EMA)."""
    return {k: _task(k).init_state(jax.random.PRNGKey(i)) for i, k in enumerate(KINDS)}


@pytest.fixture(scope="module")
def ckpts(states, tmp_path_factory):
    """kind → (trainer .ckpt, weights .pt), both JAX-native files."""
    root = tmp_path_factory.mktemp("native")
    out = {}
    for kind, state in states.items():
        trainer = save_checkpoint(root / f"{kind}.ckpt", state,
                                  {"epoch": 3, "hyper_parameters": {"kind": kind}})
        weights = save_checkpoint(root / f"{kind}-weights.pt", {"params": state.params},
                                  {"kind": "weights"})
        out[kind] = (trainer, weights)
    return out


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _same_bits(a, b) -> bool:
    """A tensor of the port's reader and flax's leaf: dtype, shape, bytes."""
    if not torch.is_tensor(a):
        return type(a) is type(b) and a == b
    b = np.asarray(b)
    return (str(a.dtype).removeprefix("torch.") == b.dtype.name
            and tuple(a.shape) == b.shape
            and a.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes() == b.tobytes())


def _same_tree(got, want) -> bool:
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_same_tree(got[k], want[k]) for k in want))
    return _same_bits(got, want)


def _blob(path) -> bytes:
    with zipfile.ZipFile(path) as zf:
        return zf.read("state.msgpack")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("which", ["trainer", "weights"])
def test_reader_equals_flax_msgpack_restore(ckpts, kind, which):
    blob = _blob(ckpts[kind][which == "weights"])
    assert _same_tree(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_reader_takes_bf16_scalars_chunks_and_python_values(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"bf16": np.asarray(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)),
            "big": rng.normal(size=(7, 9)).astype(np.float32),
            "ints": rng.integers(-2**40, 2**40, (4,)),
            "u32": np.arange(6, dtype=np.uint32).reshape(2, 3),
            "empty": np.zeros((0, 3), np.float32),
            "scalar": np.float32(2.5), "step": np.int32(-3),
            "py": {"none": None, "flag": True, "int": -123456789012, "small": 7,
                   "float": 0.1, "str": "s" * 40, "complex": complex(1.5, -2.0)}}
    # a chunk limit of 64 bytes cuts the (7, 9) f32 array (252 bytes) into 4
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.msgpack_restore(blob)
    assert _same_tree(got, serialization.msgpack_restore(blob))
    assert got["bf16"].dtype == torch.bfloat16 and got["big"].shape == (7, 9)


def _equal(state, want):
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].dtype == torch.float32, k
        assert np.array_equal(state[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("which", ["trainer", "weights"])
def test_load_any_maps_native_params_by_the_reference_names(states, ckpts, kind, which):
    params = _np(states[kind].params)
    want = {"mae": ti.mae_params_to_state, "classifier": ti.classifier_params_to_state,
            "jepa": lambda p: ti.vit_params_to_timm_state(p["encoder"])}[kind](params)
    got_kind, state, meta = t_load.load_any(ckpts[kind][which == "weights"])
    assert got_kind == j_load.load_any(ckpts[kind][which == "weights"])[0] == "native"
    assert meta["__format__"] == "ssrl_vit_mae_jepa_tpu"
    _equal(state, want)


@pytest.mark.parametrize("kind", KINDS)
def test_encoder_params_equal_the_jax_loaders(ckpts, kind):
    path = ckpts[kind][0]
    enc, report = t_load.encoder_params_from_checkpoint(path, DEPTH)
    jenc, jreport = j_load.encoder_params_from_checkpoint(path, DEPTH)
    assert jreport == {"missing": [], "unexpected": []}
    # the MAE's lightly names hold the encoder's unused mask token, which a
    # ViT has no slot for: reported, as for the JAX export's .pt file
    assert report == {"missing": [], "unexpected": ["mask_token"] if kind == "mae" else []}
    _equal(enc, ti.vit_params_to_timm_state(_np(jenc)))


def test_classifier_and_mae_params_equal_the_jax_loaders(ckpts):
    state, report, meta = t_load.classifier_params_from_checkpoint(ckpts["classifier"][0], DEPTH)
    jstate, jreport, jmeta = j_load.classifier_params_from_checkpoint(ckpts["classifier"][0],
                                                                      DEPTH)
    assert report == jreport and meta == jmeta
    _equal(state, ti.classifier_params_to_state(_np(jstate)))
    state, report = t_load.mae_params_from_checkpoint(ckpts["mae"][1], DEPTH, DEC_DEPTH)
    jstate, jreport = j_load.mae_params_from_checkpoint(ckpts["mae"][1], DEPTH, DEC_DEPTH)
    assert report == jreport
    _equal(state, ti.mae_params_to_state(_np(jstate)))


def test_the_port_trains_a_classifier_from_a_native_checkpoint(ckpts):
    """The native classifier's weights load strictly into the port's
    ``ViTClassifier`` (through ``init_params_override``) and one step runs."""
    state, _, _ = t_load.classifier_params_from_checkpoint(ckpts["classifier"][0], DEPTH)
    task = TClassifierTask(MODEL, TRAIN_CFG, dtype=torch.float32, device="cpu")
    tstate = task.init_state(0, init_params_override=lambda p: state)
    assert all(torch.equal(tstate.params[k].detach(), v) for k, v in state.items())
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (4, 96, 96, 3)).astype(np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32)),
             "weight": torch.ones(4)}
    tstate, sums = task.train_step(tstate, batch, 0)
    assert np.isfinite(float(sums["loss_sum"])) and tstate.step == 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("which", ["trainer", "weights"])
def test_convert_to_torch_writes_the_jax_clis_file(ckpts, tmp_path, kind, which):
    path = ckpts[kind][which == "weights"]
    t_kind = t_convert.main([str(path), str(tmp_path / "t.pt")])
    j_kind = j_convert.convert(path, tmp_path / "j.pt")
    assert t_kind == j_kind
    got = torch.load(tmp_path / "t.pt", weights_only=True)
    want = torch.load(tmp_path / "j.pt", weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_convert_to_torch_kind_override(ckpts, tmp_path):
    t_convert.convert(ckpts["mae"][0], tmp_path / "t.pt", "encoder")
    j_convert.convert(ckpts["mae"][0], tmp_path / "j.pt", "encoder")
    got, want = (torch.load(tmp_path / n, weights_only=True) for n in ("t.pt", "j.pt"))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="not a native checkpoint"):
        t_convert.convert(tmp_path / "j.pt", tmp_path / "x.pt")


def test_extract_weights_of_a_native_checkpoint_equals_the_jax_export(ckpts, tmp_path):
    path = ckpts["classifier"][0]
    t_extract.extract(path, tmp_path / "t.pt")
    j_convert.convert(path, tmp_path / "j.pt")
    got, want = (torch.load(tmp_path / n, weights_only=True) for n in ("t.pt", "j.pt"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_a_foreign_format_is_refused(ckpts, tmp_path):
    path = tmp_path / "foreign.ckpt"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("state.msgpack", _blob(ckpts["classifier"][1]))
        zf.writestr("meta.json", json.dumps({"__format__": "someone_else"}))
    with pytest.raises(ValueError, match="is not a ssrl_vit_mae_jepa_tpu checkpoint"):
        t_load.load_any(path)
    with pytest.raises(ValueError, match="is not a ssrl_vit_mae_jepa_tpu checkpoint"):
        t_convert.convert(path, tmp_path / "x.pt")


def test_a_native_file_without_params_is_refused(tmp_path):
    path = save_checkpoint(tmp_path / "n.ckpt", {"step": np.int32(3)})
    with pytest.raises(ValueError, match="has no params tree"):
        t_load.load_any(path)


def _fixture_state():
    """The fixture's train state: the JAX classifier task's, from key 0."""
    task = JClassifierTask(FIXTURE_MODEL, TRAIN_CFG, dtype=jnp.float32)
    return task.init_state(jax.random.PRNGKey(0))


def write_fixture(path=FIXTURE):
    path.parent.mkdir(parents=True, exist_ok=True)
    return save_checkpoint(path, _fixture_state(), {"epoch": 0, "global_step": 0})


def test_fixture_holds_the_jax_packages_checkpoint(tmp_path):
    """The committed fixture decodes to what the JAX package writes today
    from the same seed, and ``load_any`` reads it as the JAX export."""
    fresh = write_fixture(tmp_path / "fresh.ckpt")
    assert _same_tree(flax_msgpack.msgpack_restore(_blob(FIXTURE)),
                      serialization.msgpack_restore(_blob(fresh)))
    _, state, meta = t_load.load_any(FIXTURE)
    assert meta["epoch"] == 0
    _equal(state, ti.classifier_params_to_state(_np(_fixture_state().params)))


if __name__ == "__main__":
    print(write_fixture())
