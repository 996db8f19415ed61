"""The port's feature, k-NN and reconstruction entry points against the JAX
package's, on the CPU, at f32.

- ``extract_features`` (cls and mean pool, each ``normalize`` mode) and
  ``reconstruct_batch`` (with the masks the JAX function draws) on one
  checkpoint, at the tiny geometry of ``tests/test_cli.py``: f32 on both
  sides, so they differ by accumulation order only (atol 1e-4 on features;
  1e-5 on images in [0, 1] and on the masked-patch metrics).
- The framework-free copies, bit for bit: ``utils/umap_np.py`` (its fuzzy
  graph, and the embedding from the same initial layout; its numpy k-NN
  fallback finds sklearn's neighbours), ``knn_predict``, ``ridge_probe`` and
  ``matched_filter_oracle``.
- The f32 plain branch versions ``attn_branch_ref`` / ``mlp_branch_ref``
  against the JAX kernels at f32 in interpret mode (the no-grad forwards
  ``_ab_fwd_only`` and ``_mb_fwd`` that the f32 entry points reach), at the
  three f32 geometries (37, 144), (145, 144) and (145, 192): atol 5e-5, the
  f32 tolerance of ``tests/test_block_kernel.py``. The CUDA kernels of
  ``csrc/branch_f32.cu`` are held to these plain versions on the card by
  ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.data.stl10 import STL10, write_synthetic_stl10
from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.scripts.evaluation import knn_eval as t_knn
from ssrl_vit_mae_jepa_torch.scripts.evaluation import validate_instrument as t_vi
from ssrl_vit_mae_jepa_torch.scripts.evaluation import visualize_reconstruction as t_rec
from ssrl_vit_mae_jepa_torch.scripts.evaluation import visualize_representation as t_rep
from ssrl_vit_mae_jepa_torch.scripts.utils import DEVICE_ENV
from ssrl_vit_mae_jepa_torch.utils import umap_np as t_umap
from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp
from ssrl_vit_mae_jepa_tpu.utils import umap_np as j_umap

MODEL = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 32, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
    "head": {"embed_dim": 32, "pool": "cls"},
}
CFG = {"model": MODEL}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The entry points read their device from the environment."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny MAE's weights as vit-mae.pt (weights scaled up from the init so
    that the blocks do more than pass the residual through) and the
    synthetic STL-10 beside it."""
    root = tmp_path_factory.mktemp("torch_viz")
    write_synthetic_stl10(root / "data", num_train=48, num_test=16, num_unlabeled=16, seed=2)
    model = mae_from_config(MODEL)
    model.init_weights(torch.Generator().manual_seed(11))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2 and "blocks" in name:
                p.mul_(10.0)
    return {"path": export_reference_weights(root / "vit-mae.pt", model.state_dict()),
            "data": root / "data"}


@pytest.mark.parametrize("normalize", ["none", "l2", "channel"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_extract_features_matches_the_jax_function(ckpt, pool, normalize):
    from scripts.evaluation.visualize_representation import extract_features as j_extract

    kw = dict(pool=pool, normalize=normalize, split="train", batch_size=32,
              data_dir=ckpt["data"])
    want, want_y = j_extract(CFG, ckpt["path"], **kw)
    got, got_y = t_rep.extract_features(CFG, ckpt["path"], **kw)
    assert got.shape == want.shape == (48, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 0.1


def test_reconstruct_batch_matches_the_jax_function(ckpt):
    """The JAX function draws its masks from PRNGKey(MASK_SEED); the port is
    handed the same masks."""
    from scripts.evaluation.visualize_reconstruction import MASK_SEED
    from scripts.evaluation.visualize_reconstruction import reconstruct_batch as j_rec
    from ssrl_vit_mae_jepa_tpu.ops.masking import num_masked_tokens, random_token_mask

    images = STL10(ckpt["data"], "train").images_nhwc(np.arange(8))
    want = j_rec(CFG, ckpt["path"], images, 0.75)
    masks = random_token_mask(jax.random.PRNGKey(MASK_SEED), 8, 145,
                              num_masked_tokens(145, 0.75))
    got = t_rec.reconstruct_batch(CFG, ckpt["path"], images, 0.75,
                                  masks=tuple(np.asarray(m) for m in masks))
    for k in ("original", "masked", "reconstructed"):
        assert got[k].shape == (8, 96, 96, 3)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)
    for k in ("mse", "mae", "psnr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert not np.array_equal(got["masked"], got["original"])


def test_reconstruct_batch_draws_its_own_masks(ckpt):
    images = STL10(ckpt["data"], "train").images_nhwc(np.arange(4))
    a = t_rec.reconstruct_batch(CFG, ckpt["path"], images)
    b = t_rec.reconstruct_batch(CFG, ckpt["path"], images)
    assert np.isfinite(a["psnr"]) and a["mse"] == b["mse"]  # seeded by MASK_SEED


def test_random_encoder_features_run_at_f32(ckpt):
    feats, labels = t_knn.random_encoder_features(CFG, "cls", "test", 8, ckpt["data"])
    assert feats.shape == (16, 32) and feats.dtype == np.float32 and len(labels) == 16


def _blobs(n=120, d=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 4
    return centers[rng.integers(0, 4, n)] + rng.normal(size=(n, d))


def test_umap_copy_matches_the_jax_packages(monkeypatch):
    """The fuzzy graph bit for bit; the whole embedding bit for bit from the
    same initial layout. The spectral initial layout itself differs from call
    to call in both packages (ARPACK's ``eigsh`` starts from an unseeded
    random vector), so both take the seeded fallback layout here."""
    x = _blobs()
    got_g, want_g = t_umap._fuzzy_graph(x, 15, None), j_umap._fuzzy_graph(x, 15, None)
    assert (got_g != want_g).nnz == 0
    init = lambda graph, dim, rng: rng.normal(0, 1.0, (graph.shape[0], dim))  # noqa: E731
    monkeypatch.setattr(t_umap, "_spectral_init", init)
    monkeypatch.setattr(j_umap, "_spectral_init", init)
    got = t_umap.umap_embed(x, n_epochs=60, random_state=3)
    want = j_umap.umap_embed(x, n_epochs=60, random_state=3)
    assert got.shape == (120, 2)
    np.testing.assert_array_equal(got, want)


def test_umap_numpy_knn_finds_sklearns_neighbours():
    from sklearn.neighbors import NearestNeighbors

    x = _blobs(n=300, seed=1)
    d_np, i_np = t_umap._knn_numpy(x, 16, chunk=128)
    d_sk, i_sk = NearestNeighbors(n_neighbors=16).fit(x).kneighbors(x)
    np.testing.assert_array_equal(i_np[:, 0], np.arange(300))
    assert all(set(a) == set(b) for a, b in zip(i_np, i_sk))
    np.testing.assert_allclose(d_np, d_sk, atol=1e-9)


def test_knn_and_ridge_match_the_jax_package():
    from scripts.evaluation.knn_eval import knn_predict as j_knn
    from scripts.evaluation.validate_instrument import ridge_probe as j_ridge

    rng = np.random.default_rng(4)
    tr, te = rng.normal(size=(80, 16)), rng.normal(size=(30, 16))
    y = rng.integers(0, 10, 80)
    for k in (1, 5, 20, 200):
        np.testing.assert_array_equal(t_knn.knn_predict(tr, y, te, k=k), j_knn(tr, y, te, k=k))
    for lam in (1e-2, 10.0, 1e3):
        np.testing.assert_array_equal(t_vi.ridge_probe(tr, y, te, lam=lam),
                                      j_ridge(tr, y, te, lam=lam))


def test_matched_filter_matches_the_jax_package(ckpt):
    from scripts.evaluation.validate_instrument import matched_filter_oracle as j_mf

    images = STL10(ckpt["data"], "test").images_nhwc(np.arange(16))
    np.testing.assert_array_equal(t_vi.matched_filter_oracle(images), j_mf(images))


# (B, L, D, H): the MAE encoder, the feature extractor's encoder and the MAE
# decoder, at small B
F32_SHAPES = [(2, 37, 144, 6), (2, 145, 144, 6), (2, 145, 192, 6)]


def _branch_params(kind, D, seed):
    """Flax-layout params (ln_s, ln_b, Wa (in, out), ba, Wb (in, out), bb)."""
    rng = np.random.default_rng(seed)
    n = 3 * D if kind == "attn" else 4 * D
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wb_in = D if kind == "attn" else n
    return (1.0 + 0.1 * f(D), 0.1 * f(D), f(D, n) * D**-0.5, 0.1 * f(n),
            f(wb_in, D) * wb_in**-0.5, 0.1 * f(D))


@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", F32_SHAPES)
def test_f32_plain_branch_matches_the_jax_no_grad_kernel(kind, B, L, D, H):
    rng = np.random.default_rng(L + D)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    p = _branch_params(kind, D, seed=D + L)
    args = (jnp.asarray(x), *map(jnp.asarray, p))
    with pltpu.force_tpu_interpret_mode():
        want = (jbp.fused_attn_branch(*args, H) if kind == "attn"
                else jbp.fused_mlp_branch(*args))
    want = np.asarray(want)
    s, b, wa, ba, wb, bb = (torch.from_numpy(a) for a in p)
    tp = (s, b, wa.t().contiguous(), ba, wb.t().contiguous(), bb)
    with torch.no_grad():
        got = (bf.fused_attn_branch(torch.from_numpy(x), *tp, H) if kind == "attn"
               else bf.fused_mlp_branch(torch.from_numpy(x), *tp))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
