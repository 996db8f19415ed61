"""Port ops (patches, masking, augmentation, attention, schedules) against
the JAX package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops import attention as t_attn
from ssrl_vit_mae_jepa_torch.ops import augment as t_aug
from ssrl_vit_mae_jepa_torch.ops import masking as t_mask
from ssrl_vit_mae_jepa_torch.ops import patches as t_patch
from ssrl_vit_mae_jepa_torch.training import schedules as t_sched
from ssrl_vit_mae_jepa_tpu.ops import attention as j_attn
from ssrl_vit_mae_jepa_tpu.ops import augment as j_aug
from ssrl_vit_mae_jepa_tpu.ops import masking as j_mask
from ssrl_vit_mae_jepa_tpu.ops import patches as j_patch
from ssrl_vit_mae_jepa_tpu.training import schedules as j_sched


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def test_patchify_matches_jax_exactly():
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(np.float32)
    got = t_patch.patchify(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(_np(got), np.asarray(j_patch.patchify(x, 8)))
    back = t_patch.unpatchify(got[:, :4], 8)  # a square 2x2 grid of patches
    np.testing.assert_array_equal(
        _np(back), np.asarray(j_patch.unpatchify(jnp.asarray(_np(got[:, :4])), 8))
    )


def test_patchify_hcw_matches_jax_exactly():
    x = np.random.default_rng(1).normal(size=(2, 16, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t_patch.patchify_hcw(torch.from_numpy(x), 8)),
        np.asarray(j_patch.patchify_hcw(x, 8)),
    )


@pytest.mark.parametrize("L,ratio", [(145, 0.75), (17, 0.5)])
def test_random_token_mask_contract(L, ratio):
    n_mask = t_mask.num_masked_tokens(L, ratio)
    assert n_mask == j_mask.num_masked_tokens(L, ratio) == int(ratio * (L - 1))
    gen = torch.Generator().manual_seed(0)
    keep, mask = t_mask.random_token_mask(gen, 6, L, n_mask)
    assert keep.shape == (6, L - n_mask) and mask.shape == (6, n_mask)
    assert (keep[:, 0] == 0).all()
    assert (keep[:, 1:].diff(dim=-1) > 0).all()
    both = torch.cat([keep, mask], dim=-1).sort(dim=-1).values
    assert (both == torch.arange(L)).all()  # a permutation: every token once


def test_gather_scatter_match_one_hot_forms_with_grads():
    rng = np.random.default_rng(2)
    B, L, D, K = 3, 17, 8, 5
    tokens = rng.normal(size=(B, L, D)).astype(np.float32)
    value = rng.normal(size=(B, K, D)).astype(np.float32)
    idx = np.stack([rng.permutation(L)[:K] for _ in range(B)])
    g_get = rng.normal(size=(B, K, D)).astype(np.float32)
    g_set = rng.normal(size=(B, L, D)).astype(np.float32)

    def jax_loss(t, v):
        got = j_mask.get_at_index_mm(t, jnp.asarray(idx))
        put = j_mask.set_at_index_mm(t, jnp.asarray(idx), v)
        return jnp.sum(got * g_get) + jnp.sum(put * g_set), (got, put)

    (_, (j_got, j_put)), (j_dt, j_dv) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True
    )(tokens, value)

    t = torch.from_numpy(tokens).requires_grad_()
    v = torch.from_numpy(value).requires_grad_()
    ti = torch.from_numpy(idx).long()
    got = t_mask.get_at_index(t, ti)
    put = t_mask.set_at_index(t, ti, v)
    loss = (got * torch.from_numpy(g_get)).sum() + (put * torch.from_numpy(g_set)).sum()
    dt, dv = torch.autograd.grad(loss, (t, v))
    for a, b in [(got, j_got), (put, j_put), (dt, j_dt), (dv, j_dv)]:
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    rep = t_mask.repeat_token(torch.ones(1, 1, D), (B, L))
    assert rep.shape == (B, L, D)


@pytest.mark.parametrize("jit,atol", [(False, 1e-5), (True, 6e-5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_augment_patches_matches_jax(seed, jit, atol):
    """JAX-drawn (u, flip) injected into both, compared in f32.

    Op by op (``jax.disable_jit``) the JAX function computes what the port
    computes, to f32 rounding. Jitted, XLA rewrites ``size / out_n`` as a
    multiply by the reciprocal and fuses the multiply-adds of the source
    coordinates, so a coordinate (up to 95) can differ by one f32 ulp,
    7.6e-6. That moves each bilinear weight by as much, and a pixel (two
    taps per axis, values in [-1, 1]) by up to ~3e-5: hence atol 6e-5 for
    the jitted function."""
    images = np.random.default_rng(seed).integers(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    u, flip = j_aug.draw_augment_params(jax.random.PRNGKey(seed), 4)
    with jax.disable_jit(not jit):
        want = j_aug.apply_augment_patches(u, flip, images, patch_size=8, out_size=96)
    got = t_aug.apply_augment_patches(
        torch.from_numpy(np.array(u)), torch.from_numpy(np.array(flip)),
        torch.from_numpy(images), patch_size=8, out_size=96,
    )
    assert got.shape == (4, 144, 192) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def test_draw_augment_params_shapes():
    u, flip = t_aug.draw_augment_params(torch.Generator().manual_seed(0), 5)
    assert u.shape == (5, 4) and flip.shape == (5,) and flip.dtype == torch.bool
    assert ((u >= 0) & (u < 1)).all()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mha_xla_matches_jax(dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 3, 17, 16)).astype(np.float32) for _ in range(3))
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = j_attn.mha_xla(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    got = t_attn.mha_xla(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    atol = 1e-5 if dtype is np.float32 else 2e-2
    np.testing.assert_allclose(
        _np(got.float()), np.asarray(want, np.float32), atol=atol, rtol=0
    )


@pytest.mark.parametrize("epoch", [0, 3, 19, 20, 400, 799])
def test_schedules_match_jax(epoch):
    # JAX evaluates the factor in f32, the port in Python floats: near the
    # cosine's zero only the absolute error (~1 f32 ulp of 1.0) is small
    assert t_sched.warmup_cosine_factor(epoch, 20, 800) == pytest.approx(
        float(j_sched.warmup_cosine_factor(epoch, 20, 800)), rel=1e-6, abs=1e-7
    )
    assert t_sched.mask_ratio_at_epoch(epoch, 0.5, 0.85, 200) == (
        j_sched.mask_ratio_at_epoch(epoch, 0.5, 0.85, 200)
    )
    assert t_sched.effective_pretrain_lr(1.5e-4, 768) == (
        j_sched.effective_pretrain_lr(1.5e-4, 768)
    )
