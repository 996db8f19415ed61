"""The CUDA branch kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a GPU. The file imports no JAX, so it
also runs where JAX is not installed; ``tests/conftest.py`` does import JAX,
so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

bf16 throughout. The forward is held to 6e-2 absolute (the bf16 forward
tolerance of ``tests/test_block_kernel.py``). In the backward both sides
round to bf16 at different points (the plain version's autograd rounds dW,
dP and dy1 to bf16, the kernels keep them in f32), so each of the seven
outputs is held to 2% of its largest magnitude: far below the O(1)
relative error of a layout or indexing fault.
"""

import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops import block_fused as bf

# (B, L, D, H): the MAE encoder and decoder at B=768, a head dim of 12 with
# ragged L, and the longest sequence the attention backward takes at d=32
SHAPES = [(768, 37, 144, 6), (768, 145, 192, 6), (3, 17, 48, 4), (2, 160, 64, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(kind, B, L, D, device):
    g = torch.Generator().manual_seed(B + L + D)
    n = 3 * D if kind == "attn" else 4 * D
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    wb_in = D if kind == "attn" else n
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(n, D) * D**-0.5, 0.1 * rn(n),
              rn(D, wb_in) * wb_in**-0.5, 0.1 * rn(D)]
    x = rn(B, L, D).to(torch.bfloat16)
    dy = rn(B, L, D).to(torch.bfloat16)
    return x.to(device), dy.to(device), [p.to(device) for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_kernel_matches_plain(cuda, kind, B, L, D, H):
    x, dy, params = _inputs(kind, B, L, D, cuda)
    extra = (H,) if kind == "attn" else ()
    kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
    ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref

    def run(fn):
        leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
        out = fn(*leaves, *extra)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    before = dict(bf.LAUNCHES)
    out_k, grads_k = run(kern)
    out_r, grads_r = run(ref)
    fwd, bwd = f"{kind}_branch_fwd", f"{kind}_branch_bwd"
    assert bf.LAUNCHES[fwd] == before[fwd] + 1 and bf.LAUNCHES[bwd] == before[bwd] + 1
    with torch.no_grad():
        out_ns = kern(x, *params, *extra)
    torch.cuda.synchronize()
    assert torch.equal(out_ns, out_k)  # the no-stash forward: same bits
    torch.testing.assert_close(out_k.float(), out_r.float(), atol=6e-2, rtol=0)
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=bound, rtol=0)


@pytest.mark.cuda
def test_cuda_rejects_float32(cuda):
    x, _, params = _inputs("mlp", 2, 5, 16, cuda)
    with pytest.raises(TypeError):
        bf.fused_mlp_branch(x.float(), *params)
