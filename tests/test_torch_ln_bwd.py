"""The LayerNorm backward and the model-axis finish of the port, on the CPU.

``block_fused.ln_bwd_full_plain`` (and ``ln_bwd_plain`` on it) is the plain
version that the LN backward kernel (``csrc/common.cuh::ln_bwd``, under
every branch, block and chain backward and the TP ``branch_ln_bwd``) is
held to on the card. Here it is held to the JAX package's
``block_pallas._ln_fwd`` / ``_ln_bwd`` plus the residual gradient gy and
its column sum, on the same seeded numpy inputs: dx before its rounding
within 1e-5 at f32 (each column sum, a sum of M terms in another order,
within 1e-5 of its largest) and within ``tests/test_torch_tp.py``'s
bounds (rtol 1e-4, atol 1e-5) in bf16; the
bf16 dx is its own f32 dx rounded once, and within one bf16 step of the
JAX f32 dx rounded (the two f32 values differ by ~1e-7, so a value on a
rounding boundary may round either way). ``branch_finish_plain`` is the
JAX rounding ``x + (s + b).astype(bf16)`` bit for bit. The kernel sums
its columns in a block order of its own (rows a thread, then the block's
row slots, blocks of a group, groups); ``ln_colsum_blocked`` mirrors it
and is held to the plain column sum at f32, and ``ln_bwd_plan`` (the
kernel's plan) to its invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as bp

TP_RTOL, TP_ATOL = 1e-4, 1e-5  # tests/test_torch_tp.py's LN backward bounds
F32_TOL = 1e-5


def _inputs(M, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32) * 2.0 + 0.5
    s = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    dy = rng.standard_normal((M, D)).astype(np.float32)
    gy = rng.standard_normal((M, D)).astype(np.float32)
    return x, s, dy, gy


def _bf16(a):
    """numpy f32 values rounded to bf16, as f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@jax.jit
def _jax_ln_bwd_f32(x, s, dy, g):
    _, xhat, inv = bp._ln_fwd(x, s[None], jnp.zeros_like(s)[None])
    dx, ds, db = bp._ln_bwd(dy, xhat, inv, s[None])
    return g + dx, ds[0], db[0]


def _jax_ln_bwd(x, s, dy, g):
    """The JAX package's LN backward plus the residual: (g + dx, d scale,
    d bias, sum g), all f32 (one compile a shape)."""
    r, ds, db = _jax_ln_bwd_f32(x, s, dy, g)
    return np.asarray(r), np.asarray(ds), np.asarray(db), np.asarray(g).sum(0)


@pytest.fixture(scope="module", autouse=True)
def _first_calls():
    """JAX's first jit and ``torch.testing``'s first comparison (each about
    a second, once a process), outside the cases' times."""
    z = np.zeros((1, 8), np.float32)
    _jax_ln_bwd(z, np.ones(8, np.float32), z, z)
    torch.testing.assert_close(torch.zeros(1), torch.zeros(1))


@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16_gy32"])
@pytest.mark.parametrize("M", [1, 17, 333])
@pytest.mark.parametrize("D", [96, 144, 192])
def test_ln_bwd_plain_matches_jax(D, M, kind):
    """``ln_bwd_full_plain`` at f32, in bf16 (gy bf16, the branch
    backward's) and in bf16 with an f32 gy (the whole block's and chain's)
    against the JAX LN backward on the same inputs."""
    x, s, dy, gy = _inputs(M, D, seed=M * 1000 + D)
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    if dt == torch.bfloat16:
        x = _bf16(x)  # the values a bf16 x holds
    g = gy if kind != "bf16" else _bf16(gy)
    gt = torch.from_numpy(gy).to(torch.float32 if kind != "bf16" else torch.bfloat16)
    dx, d32, (ds, db, sg) = bf.ln_bwd_full_plain(
        torch.from_numpy(x).to(dt), torch.from_numpy(s), torch.from_numpy(dy), gt)
    want, ds_w, db_w, sg_w = _jax_ln_bwd(x, s, dy, g)
    rtol, atol = (F32_TOL, F32_TOL) if kind == "f32" else (TP_RTOL, TP_ATOL)
    assert dx.dtype == dt and d32.dtype == torch.float32 and dx.shape == (M, D)
    torch.testing.assert_close(d32, torch.from_numpy(want.copy()), rtol=rtol, atol=atol)
    for got, ref in ((ds, ds_w), (db, db_w), (sg, sg_w)):
        ref = torch.from_numpy(ref.copy())
        if kind == "f32":  # sums of M terms: 1e-5 of the largest
            torch.testing.assert_close(got, ref, rtol=0, atol=F32_TOL * ref.abs().max().item())
        else:
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    if dt == torch.bfloat16:
        assert torch.equal(dx, d32.to(dt))  # rounded once
        ref = torch.from_numpy(want.copy()).bfloat16().float()
        step = ref.abs().clamp_min(2.0**-126) * 2.0**-7  # one bf16 step and over
        assert ((dx.float() - ref).abs() <= step).all()
        # ln_bwd_plain, the TP entry's plain version, is the same function
        dxp, (dsp, dbp, sgp) = bf.ln_bwd_plain(
            torch.from_numpy(x).to(dt), torch.from_numpy(s), torch.from_numpy(dy), gt.to(dt))
        if kind == "bf16":
            assert torch.equal(dxp, dx) and torch.equal(sgp, sg)
        assert torch.equal(dsp, ds) and torch.equal(dbp, db)


@pytest.mark.parametrize("D", [8, 96, 144, 192])
def test_branch_finish_plain_is_the_jax_rounding(D):
    """``branch_finish_plain`` = the JAX ``x + (s + b).astype(bf16)`` bit for
    bit, at a ragged row count."""
    rng = np.random.default_rng(D)
    M = 333
    x = _bf16(rng.standard_normal((M, D)).astype(np.float32))
    s = (3.0 * rng.standard_normal((M, D))).astype(np.float32)
    b = _bf16((0.1 * rng.standard_normal(D)).astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = xj + (jnp.asarray(s) + jnp.asarray(b).astype(jnp.bfloat16)).astype(jnp.bfloat16)
    got = bf.branch_finish_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(s),
                                 torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("M", [1, 17, 333, 28416])
@pytest.mark.parametrize("D", [96, 144, 192])
def test_ln_colsum_blocked_matches_plain(D, M):
    """The kernel's column-sum order (``ln_colsum_blocked``) against the
    plain column sums of the LN backward's three terms at f32, within 1e-5
    of their largest."""
    x, s, dy, gy = _inputs(M, D, seed=D + M)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    _, _, (ds, db, sg) = bf.ln_bwd_full_plain(xt, torch.from_numpy(s), dyt, torch.from_numpy(gy))
    xc = xt - xt.mean(-1, keepdim=True)
    xhat = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + bf.LN_EPS)
    for got, want in ((bf.ln_colsum_blocked(dyt * xhat), ds), (bf.ln_colsum_blocked(dyt), db),
                      (bf.ln_colsum_blocked(torch.from_numpy(gy)), sg)):
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * want.abs().max().item())


@pytest.mark.parametrize("D", [1, 8, 48, 96, 100, 144, 192, 256])
def test_ln_bwd_plan_covers_every_row(D):
    """The kernel's plan: a row's G threads fit a block of 256 side by side,
    the blocks' row ranges cover the rows exactly once, no block is empty,
    the grid stays within two blocks an SM, and the done counters within
    the workspace's LNB_DONE."""
    for M in (1, 2, 7, 17, 333, 1000, 28416, 111360, 10**6):
        p = bf.ln_bwd_plan(M, D)
        assert p["G"] * p["RB"] <= bf.LNB_THREADS and p["RB"] >= 1
        assert p["G"] * 8 >= D > (p["G"] - 1) * 8
        assert (p["blocks"] - 1) * p["rpb"] < M <= p["blocks"] * p["rpb"]
        assert 1 <= p["blocks"] <= bf.LNB_MAX_BLOCKS
        assert p["groups"] + 1 <= -(-bf.LNB_MAX_BLOCKS // bf.LNB_GROUP) + 1
