"""The attention slice: the port's four attention entries and the MAE step
under ``attn_impl="packed"`` and ``"pallas"``, against the JAX package.

Each entry's plain version (what the CPU path runs, and what the CUDA kernel
is held to on the card by ``tests/test_torch_cuda.py``) against the JAX
Pallas kernel run in interpret mode, as ``tests/test_attention.py`` runs it:
forward and every gradient, at the tolerances of that file (f32: 2e-5
forward, 1e-4 backward, accumulation order only; bf16: 1e-2 forward, 2.5e-2
backward, where a product that lands on a rounding boundary of P or dS may
round the other way). Then the whole MAE loss and its gradients through
``MAETask`` with the same attn_impl on both sides, in f32 (loss rel 1e-5;
gradients atol 5e-5, the bound of ``tests/test_attention.py:256``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.models.vit import Block, vit_from_config
from ssrl_vit_mae_jepa_torch.ops import attention as tatt
from ssrl_vit_mae_jepa_torch.ops import attention_core
from ssrl_vit_mae_jepa_torch.ops.attention_heads import mha_pallas, mha_pallas_ref
from ssrl_vit_mae_jepa_torch.ops.attention_packed import mha_packed, mha_packed_ref
from ssrl_vit_mae_jepa_torch.ops.attention_stacked import (
    mha_stacked,
    mha_stacked_qkv,
    mha_stacked_qkv_ref,
    mha_stacked_ref,
)
from ssrl_vit_mae_jepa_torch.ops.block_chain import chain_impl
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_from_jax, mae_params_to_state
from ssrl_vit_mae_jepa_tpu.ops import attention_pallas as jpal
from ssrl_vit_mae_jepa_tpu.ops import attention_pallas_packed as jpacked
from ssrl_vit_mae_jepa_tpu.ops import attention_pallas_stacked as jstacked
from ssrl_vit_mae_jepa_tpu.ops.augment import apply_augment_patches, draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from tests.test_torch_mae_step import CFG, PRE_CFG

# (B, L, H, d): the MAE encoder's head geometry, a small ragged one, the
# decoder's L=145 and the JEPA predictor's d=16
SHAPES = [(2, 37, 6, 24), (2, 17, 2, 8), (2, 145, 6, 32), (2, 145, 6, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_ATOL = {"float32": 2e-5, "bfloat16": 1e-2}
BWD_ATOL = {"float32": 1e-4, "bfloat16": 2.5e-2}


def _to_heads(x, B, L, H, d):
    return x.reshape(B, L, H, d).transpose(0, 2, 1, 3)


def _jax_fn(entry, H):
    """The JAX entry as a function of three q, k, v in its input layout."""
    if entry == "mha_stacked_qkv":
        return lambda q, k, v: jstacked.mha_stacked_qkv(jnp.concatenate([q, k, v], -1), H)
    if entry == "mha_stacked":
        return lambda q, k, v: jstacked.mha_stacked(q, k, v, H)
    if entry == "mha_packed":
        return lambda q, k, v: jpacked.mha_packed(q, k, v, H)
    return lambda q, k, v: jpal.mha_pallas(q, k, v)


# entry -> (the port's wrapper, its plain version)
PORT = {
    "mha_stacked_qkv": (mha_stacked_qkv, mha_stacked_qkv_ref),
    "mha_stacked": (mha_stacked, mha_stacked_ref),
    "mha_packed": (mha_packed, mha_packed_ref),
    "mha_pallas": (mha_pallas, mha_pallas_ref),
}


def _inputs(entry, B, L, H, d, seed):
    """q, k, v, g from a numpy seed in the entry's layout (numpy f32)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, L, H * d)).astype(np.float32) for _ in range(4)]
    if entry == "mha_pallas":
        xs = [np.ascontiguousarray(_to_heads(x, B, L, H, d)) for x in xs]
    return xs


def _port_run(fn, entry, xs, g, H, tdt):
    ts = [torch.from_numpy(x).to(tdt) for x in xs]
    if entry == "mha_stacked_qkv":
        leaves = [torch.cat(ts, dim=-1).requires_grad_()]
        out = fn(leaves[0], H)
    else:
        leaves = [t.requires_grad_() for t in ts]
        out = fn(*leaves) if entry == "mha_pallas" else fn(*leaves, H)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    return out.detach().float().numpy(), [t.float().numpy() for t in grads]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,L,H,d", SHAPES)
@pytest.mark.parametrize("entry", list(PORT))
def test_plain_matches_pallas_kernel(entry, B, L, H, d, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = _inputs(entry, B, L, H, d, seed=B * L + d)
    with pltpu.force_tpu_interpret_mode():
        j_out, vjp = jax.vjp(_jax_fn(entry, H), *(jnp.asarray(x, jdt) for x in (q, k, v)))
        j_grads = vjp(jnp.asarray(g, jdt))
    j_grads = [np.asarray(t, np.float32) for t in j_grads]
    if entry == "mha_stacked_qkv":
        j_grads = [np.concatenate(j_grads, axis=-1)]
    wrapper, ref = PORT[entry]
    attention_core.reset_launch_counts()
    out, grads = _port_run(ref, entry, (q, k, v), g, H, tdt)
    w_out, w_grads = _port_run(wrapper, entry, (q, k, v), g, H, tdt)
    assert not any(attention_core.LAUNCHES.values())  # the CPU never launches
    np.testing.assert_array_equal(w_out, out)  # on the CPU the wrapper is the plain version
    for a, b in zip(w_grads, grads):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out, np.asarray(j_out, np.float32), atol=FWD_ATOL[dtype], rtol=0)
    assert len(grads) == len(j_grads)
    for name, a, b in zip("qkv" if len(grads) == 3 else ["qkv"], grads, j_grads):
        np.testing.assert_allclose(a, b, atol=BWD_ATOL[dtype], rtol=0, err_msg=f"d{name}")


def _jax_loss_and_grads(impl, B=4):
    """The JAX MAETask's f32 loss and gradients at the toy geometry, with
    the attention kernels in interpret mode, and the draws it made."""
    jtask = JMAETask(CFG, PRE_CFG, dtype=jnp.float32, attn_impl=impl)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    ctx = jtask.epoch_context(0)
    images = np.random.default_rng(0).integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(B, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, B)
    idx_keep, idx_mask = random_token_mask(task_rng, B, jtask.sequence_length, ctx)
    jimages = apply_augment_patches(u, flip, images, patch_size=8, out_size=96)

    def loss_fn(p):
        return jtask.loss_and_metric_sums(p, jimages, batch, task_rng, ctx)

    with pltpu.force_tpu_interpret_mode():
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    np_tree = lambda t: jax.tree.map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    draws = [torch.from_numpy(np.array(a)) for a in (u, flip, idx_keep, idx_mask)]
    return (float(loss), np_tree(grads), np_tree(jstate.params), ctx,
            images, batch["weight"], draws[:2] + [t.long() for t in draws[2:]])


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_mae_step_matches_jax(impl):
    """The whole slice: MAETask's loss and every gradient through the
    sub-layer route and the attention entry ``impl`` selects."""
    jloss, jgrads, params0, ctx, images, weight, draws = _jax_loss_and_grads(impl)
    task = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu", attn_impl=impl)
    state = task.init_state(0)
    mae_params_from_jax(params0, task.model)
    assert all(blk.route is None for blk in task.model.encoder.vit.blocks)
    u, flip, keep, mask = draws
    attention_core.reset_launch_counts()
    imgs = task.preprocess_train(u, flip, torch.from_numpy(images))
    tbatch = {"weight": torch.from_numpy(weight)}
    loss, _ = task.loss_and_metric_sums(imgs, tbatch, (keep, mask), ctx)
    names = list(state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    assert not any(attention_core.LAUNCHES.values())
    assert loss.item() == pytest.approx(jloss, rel=1e-5)
    want = mae_params_to_state(jgrads)
    assert set(grads) == set(want) - {"encoder.mask_token"}
    for name, gr in grads.items():
        np.testing.assert_allclose(gr.numpy(), want[name], atol=5e-5, rtol=0, err_msg=name)


def test_validate_impl_rejects_a_typo():
    for bad in ("XLA", "spit", ""):
        with pytest.raises(ValueError, match="unknown attn_impl"):
            tatt.validate_impl(bad)
        with pytest.raises(ValueError, match="unknown attn_impl"):
            Block(48, 4, attn_impl=bad)


def _chain(B=768, L=37, D=144, H=6, depth=4, impl="chain"):
    return chain_impl(B, L, D, H, 4 * D, depth, impl)


# case -> (what it runs, what it must give: a value, or the error it raises)
ROUTES = {
    "block_is_mono": (lambda: Block(48, 4, attn_impl="block").route, "mono"),
    "chain_block_is_sublayer": (lambda: Block(48, 4, attn_impl="chain").route, None),
    "chain_forced": (lambda: _chain(), True),
    "chain_depth_1": (lambda: _chain(depth=1), ValueError),
    "chain_d_mod_h": (lambda: _chain(D=100, H=6), ValueError),
    "chain_beyond_fit": (lambda: _chain(L=161, D=64, H=2), ValueError),
    "auto_never_chains": (lambda: _chain(impl="auto"), False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_block_and_chain_routes(case):
    """The whole-block and chain policies (``block_pallas.block_impl``,
    ``block_chain.chain_impl``): "block" takes the whole-block kernel, a
    single "chain" block the sub-layer route; the stack takes the chain only
    when forced, and a forced chain refuses depth 1, D % H and shapes beyond
    the kernels' fit."""
    run, want = ROUTES[case]
    if isinstance(want, type) and issubclass(want, Exception):
        with pytest.raises(want):
            run()
    else:
        assert run() == want


def test_block_routes():
    impls = ("auto", "split", "split_pad", "xla", "pallas", "packed", "stacked", "block", "chain")
    routes = {impl: Block(48, 4, attn_impl=impl).route for impl in impls}
    assert routes == {"auto": "split", "split": "split", "split_pad": "split",
                      "xla": None, "pallas": None, "packed": None, "stacked": None,
                      "block": "mono", "chain": None}


def test_vit_from_config_takes_attn_impl():
    vit = vit_from_config(CFG, torch.float32, attn_impl="pallas")
    assert (vit.embed_dim, len(vit.blocks), vit.blocks[0].attn.num_heads) == (48, 2, 4)
    assert all(b.route is None and b.attn.attn_impl == "pallas" for b in vit.blocks)
    assert all(b.route == "split" for b in vit_from_config(CFG).blocks)


def test_fits_the_kernels_shared_memory():
    assert attention_core.fits(145, 32) and attention_core.fits(160, 32)
    assert attention_core.fits(37, 24) and attention_core.fits(145, 16)
    assert not attention_core.fits(161, 32)  # the backward's P and dS outgrow 227 KB
    assert not attention_core.fits(37, 33)  # head dims above 32
    assert not attention_core.fits(0, 8)


def test_dispatch_policies():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    bf = torch.bfloat16
    # forced packed takes the fused-qkv kernel wherever it fits, and raises beyond
    assert tatt.use_packed(2, 37, 48, 4, bf, "packed", cpu)
    with pytest.raises(ValueError, match="unsupported"):
        tatt.use_packed(2, 37, 256, 4, bf, "packed", cuda)  # d=64
    with pytest.raises(ValueError, match="unsupported"):
        tatt.use_packed(2, 512, 192, 6, bf, "packed", cuda)  # L beyond the fit
    # auto/stacked: the card at D >= 128 with d >= 24, never the CPU
    for impl in ("auto", "stacked"):
        assert tatt.use_packed(768, 145, 192, 6, bf, impl, cuda)
        assert not tatt.use_packed(768, 145, 192, 6, bf, impl, cpu)
        assert not tatt.use_packed(768, 145, 96, 6, bf, impl, cuda)
    assert not tatt.use_packed(768, 145, 192, 6, bf, "xla", cuda)
    assert not tatt.use_packed(768, 145, 192, 6, bf, "pallas", cuda)
    # the three-input kernel: auto only, D < 128, on the card
    assert tatt.use_stacked_split(768, 145, 96, 6, bf, "auto", cuda)
    assert not tatt.use_stacked_split(768, 145, 96, 6, bf, "auto", cpu)
    assert not tatt.use_stacked_split(768, 145, 96, 6, bf, "stacked", cuda)
    assert not tatt.use_stacked_split(768, 145, 192, 6, bf, "auto", cuda)


def test_multi_head_attention_dispatch_on_the_cpu():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 70, 8)).astype(np.float32))
               for _ in range(3))
    xla = tatt.mha_xla(q, k, v)
    # auto stays on the plain path off the card; forced pallas takes the entry
    assert torch.equal(tatt.multi_head_attention(q, k, v, "auto"), xla)
    assert torch.equal(tatt.multi_head_attention(q, k, v, "pallas"), mha_pallas_ref(q, k, v))
    with pytest.raises(ValueError, match="pallas attention unsupported"):
        tatt.multi_head_attention(*(torch.zeros(1, 2, 8, 64) for _ in range(3)), "pallas")
