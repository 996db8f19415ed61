"""The f32 MLP half as one kernel each way, alone: ``mlp_half`` /
``mlp_half_bwd`` at f32 (``csrc/block_mlp_f32.cu`` on the card, the plain
versions ``mlp_fwd_plain`` / ``mlp_bwd_plain`` on a CPU tensor) against the
JAX Pallas kernel ``block_pallas.fused_mlp_branch`` in interpret mode, as
``tests/test_block_kernel.py`` runs it; its shape guard against the C
guard ``ssrl::mlp_f32_ok``; and its launch counters. The CUDA kernel is held
to the plain versions on the card by ``tests/test_torch_cuda.py``.

Tolerances: those of ``tests/test_block_kernel.py`` at f32 -- the forward
within 5e-5, every gradient within 3e-4 absolute plus 1e-6 relative: the two
sides sum in other orders, and the TPU kernel's GELU takes a rational erf
within 1.5e-7 of the exact one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp

B, L, D, F = 2, 17, 48, 192
FWD_ATOL = 5e-5
BWD_ATOL, BWD_RTOL = 3e-4, 1e-6
NAMES = ["dx", "d_ln_s", "d_ln_b", "d_w1", "d_b1", "d_w2", "d_b2"]


def _mlp_params(seed):
    """The MLP's six params in flax layouts (kernels (in, out)), numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return [1.0 + 0.1 * f(D), 0.1 * f(D), f(D, F) * D**-0.5, 0.1 * f(F),
            f(F, D) * F**-0.5, 0.1 * f(D)]


def test_f32_mlp_half_matches_the_pallas_mlp_branch():
    """At f32 the MLP half is the MLP branch (every rounding point a no-op,
    ``round_z`` too): forward, the input gradient (the output gradient
    added) and the six parameter gradients of ``mlp_half`` /
    ``mlp_half_bwd`` on CPU tensors against the JAX kernel's vjp; nothing
    launches."""
    rng = np.random.default_rng(19)
    x, g = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    p = _mlp_params(seed=3)
    with pltpu.force_tpu_interpret_mode():
        j_out, vjp = jax.vjp(lambda x, *p: jbp.fused_mlp_branch(x, *p),
                             jnp.asarray(x), *map(jnp.asarray, p))
        j_grads = vjp(jnp.asarray(g))
    want = [np.asarray(t, np.float32) for t in j_grads]
    tp = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)) for a in p]
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    bf.reset_launch_counts()
    for round_z in (True, False):
        out = bf.mlp_half(xt, tp, round_z)
        dx, grads = bf.mlp_half_bwd(xt, tp, gt, round_z)
        assert out.dtype == dx.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out, np.float32), atol=FWD_ATOL,
                                   rtol=0, err_msg="forward")
        # (d ln_s, d ln_b, d w1, d b1, d w2, d b2) -> the JAX argument order
        got = [dx] + list(grads)
        assert all(t.dtype == torch.float32 for t in got)
        got = [t.numpy().T if t.dim() == 2 else t.numpy() for t in got]
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_allclose(a, b.reshape(a.shape), atol=BWD_ATOL, rtol=BWD_RTOL,
                                       err_msg=f"round_z={round_z} {name}")
    assert not any(bf.LAUNCHES.values())


def test_f32_mlp_half_counts_under_its_own_keys():
    """The f32 MLP half alone counts under ``mlp_half_fwd_f32`` /
    ``mlp_half_bwd_f32``; the whole block and chain wrappers'
    ``count_mlp_half`` counts the bf16 half only, one a block each way,
    since the f32 block and chain run the split f32 MLP sequence."""
    for key in ("mlp_half_fwd", "mlp_half_bwd", "mlp_half_fwd_f32", "mlp_half_bwd_f32"):
        assert key in bf.LAUNCHES
    bf.reset_launch_counts()
    bf.count_mlp_half(torch.float32, "fwd", 4)
    bf.count_mlp_half(torch.float32, "bwd", 2)
    bf.count_mlp_half(torch.bfloat16, "bwd", 3)
    assert {k: v for k, v in bf.LAUNCHES.items() if v} == {"mlp_half_bwd": 3}
    bf.reset_launch_counts()


@pytest.mark.parametrize("D_,F_,ok", [(48, 192, True), (192, 768, True), (256, 1024, True),
                                      (1, 1, True), (45, 180, True), (100, 7, True),
                                      (257, 1028, False), (0, 4, False), (48, 0, False)])
def test_f32_mlp_half_guard_is_mlp_f32_ok(D_, F_, ok):
    """At f32 ``mlp_half_supported`` / ``check_mlp_half`` take what
    ``ssrl::mlp_f32_ok`` takes (any M, 1 <= D <= 256, any F >= 1: the
    kernel masks every edge); bf16 keeps its multiples of 8."""
    assert bf.mlp_half_supported(D_, F_, torch.float32) == ok
    if D_ < 1 or F_ < 1:
        return
    x = torch.zeros(2, 3, D_)
    params = [torch.zeros(D_), torch.zeros(D_), torch.zeros(F_, D_), torch.zeros(F_),
              torch.zeros(D_, F_), torch.zeros(D_)]
    if ok:
        assert bf.check_mlp_half(x, params) == F_
    else:
        with pytest.raises(ValueError, match="do not take"):
            bf.check_mlp_half(x, params)
    bf16_ok = 8 <= D_ <= 256 and D_ % 8 == 0 and F_ >= 8 and F_ % 8 == 0
    assert bf.mlp_half_supported(D_, F_) == bf16_ok
