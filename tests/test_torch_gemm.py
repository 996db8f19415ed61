"""The branch kernels' GEMM as a plain version, on the CPU: ``gemm_ref``
(``ops/block_fused.py``), one product with its epilogue's rounding contract,
composed along the launch sequences of ``csrc/attn_branch.cu`` and
``csrc/mlp_branch.cu``, gives the plain branches that the JAX Pallas kernels
are held to (``tests/test_torch_block.py``): the forwards
``attn_branch_ref`` / ``mlp_branch_ref`` (and the whole block's f32-z MLP)
and the backwards ``attn_bwd_plain`` / ``mlp_bwd_plain``. The sequences
compute the same products in the same order, so they agree bit for bit.

The kernel itself is held to ``gemm_ref`` on the card
(``tests/test_torch_cuda.py``); here ``gemm`` on a CPU tensor is
``gemm_ref``.
"""

import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.ops.attention import mha_xla
from ssrl_vit_mae_jepa_torch.ops.attention_core import heads_of, plain_bwd_f32

# (B, L, D, H): a ragged toy geometry; F = 4D
B, L, D, H = 2, 9, 16, 2
F = 4 * D


def _inputs(kind: str, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    rn = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    n = 3 * D if kind == "attn" else F
    wb_in = D if kind == "attn" else F
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), (rn(n, D) * D**-0.5).to(dtype),
              (0.1 * rn(n)).to(dtype), (rn(D, wb_in) * wb_in**-0.5).to(dtype),
              (0.1 * rn(D)).to(dtype)]
    return rn(B, L, D).to(dtype), rn(B, L, D).to(dtype), params


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _attention(qkv, dt):
    """The attention core of ``attn_fwd_plain`` on the fused (B·L, 3D) qkv."""
    q, k, v = qkv.reshape(B, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
    q = (q.float() * (1.0 / (D // H) ** 0.5)).to(dt)
    return mha_xla(q, k, v, scale=1.0).transpose(1, 2).reshape(B * L, D)


def _attn_fwd_seq(x, p):
    """ln_qkv, attention, then the projection with bias and residual."""
    s, b, wqkv, bqkv, wp, bp = p
    y1 = bf.layer_norm(x, s, b).to(x.dtype)
    (qkv,) = bf.gemm_ref(_rows(y1), wqkv, "nt", "bias_bf16", bias=bqkv)
    a = _attention(qkv, x.dtype)
    (out,) = bf.gemm_ref(a, wp, "nt", "bias_resid", bias=bp, resid=_rows(x))
    return out.reshape(x.shape), a.reshape(x.shape)


def _mlp_fwd_seq(x, p, round_z=True):
    s, b, w1, b1, w2, b2 = p
    y2 = bf.layer_norm(x, s, b).to(x.dtype)
    h, z = bf.gemm_ref(_rows(y2), w1, "nt", "bias_gelu" if round_z else "bias_gelu32", bias=b1)
    (out,) = bf.gemm_ref(h, w2, "nt", "bias_resid", bias=b2, resid=_rows(x))
    return out.reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_forward_sequence_is_the_plain_branch(dtype):
    x, _, p = _inputs("attn", dtype)
    out, a = _attn_fwd_seq(x, p)
    ref_out, ref_a = bf.attn_fwd_plain(x, p, H)
    assert torch.equal(a, ref_a)
    assert torch.equal(out, ref_out)
    assert torch.equal(out, bf.attn_branch_ref(x, *p, H))


@pytest.mark.parametrize("round_z", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_forward_sequence_is_the_plain_branch(dtype, round_z):
    x, _, p = _inputs("mlp", dtype)
    out = _mlp_fwd_seq(x, p, round_z)
    assert torch.equal(out, bf.mlp_fwd_plain(x, p, round_z=round_z))
    if round_z:
        assert torch.equal(out, bf.mlp_branch_ref(x, *p))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_backward_sequence_is_the_plain_backward(dtype):
    """recompute qkv; dWp (TN), da (NN, bf16), the attention backward, dWqkv
    (TN), dy1 (NN, f32), the LayerNorm backward."""
    x, gy, p = _inputs("attn", dtype)
    s, b, wqkv, bqkv, wp, _ = p
    dt = x.dtype
    _, a = bf.attn_fwd_plain(x, p, H)
    y1 = bf.layer_norm(x, s, b).to(dt)
    (qkv,) = bf.gemm_ref(_rows(y1), wqkv, "nt", "bias_bf16", bias=bqkv)
    g = _rows(gy)
    (dwp,) = bf.gemm_ref(g, _rows(a), "tn", "f32")
    (da,) = bf.gemm_ref(g, wp, "nn", "bf16")
    q, k, v = (heads_of(t.reshape(B, L, D), H) for t in qkv.chunk(3, dim=-1))
    parts = plain_bwd_f32(q, k, v, heads_of(da.reshape(B, L, D), H), post=False)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B * L, D) for t in parts], dim=-1)
    (dwqkv,) = bf.gemm_ref(dqkv.to(dt), _rows(y1), "tn", "f32")
    (dy1,) = bf.gemm_ref(dqkv.to(dt), wqkv, "nn", "f32")
    dx, ds, db = bf._ln_bwd(dy1.reshape(x.shape), x, s)

    ref_dx, (r_ds, r_db, r_dwqkv, r_dbqkv, r_dwp, r_dbp) = bf.attn_bwd_plain(
        x, p, a, gy.float(), H)
    for got, want in ((gy.float() + dx, ref_dx), (ds, r_ds), (db, r_db), (dwqkv, r_dwqkv),
                      (dqkv.sum(0), r_dbqkv), (dwp, r_dwp), (g.float().sum(0), r_dbp)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("round_z", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_backward_sequence_is_the_plain_backward(dtype, round_z):
    """recompute fc1 (keeping z); dW2 (TN), dz and db1 (NN with the GELU
    backward), dW1 (TN), dy2 (NN, f32), the LayerNorm backward."""
    x, gy, p = _inputs("mlp", dtype)
    s, b, w1, b1, w2, _ = p
    dt = x.dtype
    y2 = bf.layer_norm(x, s, b).to(dt)
    h, z = bf.gemm_ref(_rows(y2), w1, "nt", "bias_gelu" if round_z else "bias_gelu32", bias=b1)
    g = _rows(gy)
    (dw2,) = bf.gemm_ref(g, h, "tn", "f32")
    dz, db1 = bf.gemm_ref(g, w2, "nn", "gelu_bwd" if round_z else "gelu32_bwd", z=z)
    (dw1,) = bf.gemm_ref(dz, _rows(y2), "tn", "f32")
    (dy2,) = bf.gemm_ref(dz, w1, "nn", "f32")
    dx, ds, db = bf._ln_bwd(dy2.reshape(x.shape), x, s)

    ref_dx, (r_ds, r_db, r_dw1, r_db1, r_dw2, r_db2) = bf.mlp_bwd_plain(
        x, p, gy.float(), round_z=round_z)
    for got, want in ((gy.float() + dx, ref_dx), (ds, r_ds), (db, r_db), (dw1, r_dw1),
                      (db1, r_db1), (dw2, r_dw2), (g.float().sum(0), r_db2)):
        assert torch.equal(got, want)


def _operands(layout, M, N, K, seed=1):
    rng = np.random.default_rng(seed)
    rn = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    a = rn(K, M) if layout == "tn" else rn(M, K)
    b = rn(N, K) if layout == "nt" else rn(K, N)
    extra = {"bias": rn(N), "resid": rn(M, N), "z": rn(M, N)}
    return a.to(torch.bfloat16), b.to(torch.bfloat16), {
        k: v.to(torch.bfloat16) for k, v in extra.items()}


@pytest.mark.parametrize("layout,epi", [(lay, e) for lay, es in bf.GEMM_EPIS.items()
                                        for e in es])
def test_gemm_ref_contracts(layout, epi):
    """Each epilogue's rounding points, from an f64 product; and ``gemm`` on
    CPU tensors is ``gemm_ref``."""
    M, N, K = 13, 24, 40
    a, b, ex = _operands(layout, M, N, K)
    args = {"bias": ex["bias"], "resid": ex["resid"], "z": ex["z"]}
    out = bf.gemm_ref(a, b, layout, epi, **args)
    ad, bd = a.double(), b.double()
    acc = ad @ bd.t() if layout == "nt" else (ad @ bd if layout == "nn" else ad.t() @ bd)
    bias = ex["bias"].double()
    rnd = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    tol = dict(rtol=1e-6, atol=1e-5)
    if epi == "f32":
        torch.testing.assert_close(out[0].double(), acc, **tol)
    elif epi == "bf16":
        assert out[0].dtype == torch.bfloat16
        torch.testing.assert_close(out[0].double(), rnd(acc), **tol)
    elif epi == "bias_bf16":
        torch.testing.assert_close(out[0].double(), rnd(acc + bias), **tol)
    elif epi == "bias_resid":
        torch.testing.assert_close(out[0].double(), rnd(ex["resid"].double() + rnd(acc + bias)),
                                   **tol)
    elif epi in ("bias_gelu", "bias_gelu32"):
        z = rnd(acc + bias) if epi == "bias_gelu" else acc + bias
        assert out[1].dtype == (torch.bfloat16 if epi == "bias_gelu" else torch.float32)
        torch.testing.assert_close(out[1].double(), z, **tol)
        gelu = 0.5 * z * (1.0 + torch.erf(z / 2**0.5))
        torch.testing.assert_close(out[0].double(), rnd(gelu), rtol=1e-2, atol=1e-2)
    else:
        z = ex["z"].double()
        dz = acc * (0.5 * (1 + torch.erf(z / 2**0.5)) + z * torch.exp(-z * z / 2) / (2 * np.pi)**0.5)
        torch.testing.assert_close(out[1].double(), dz.sum(0), rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(out[0].double(), rnd(dz), rtol=1e-2, atol=1e-2)
    for got, want in zip(bf.gemm(a, b, layout, epi, **args), out):
        assert torch.equal(got, want)


def test_gemm_refuses_what_it_does_not_take():
    a, b, ex = _operands("nt", 8, 16, 8)
    with pytest.raises(ValueError, match="epilogues"):
        bf.gemm_ref(a, b, "nt", "f32")
    with pytest.raises(ValueError, match="epilogues"):
        bf.gemm_ref(a, b.t(), "tn", "bf16")
    with pytest.raises(ValueError, match="layout"):
        bf.gemm_ref(a, b, "tt", "f32")
    with pytest.raises(ValueError, match="disagree"):
        bf.gemm_ref(a, b[:, :4], "nt", "bias_bf16", bias=ex["bias"])


class _RecordingLib:
    """A stand-in for the kernel library that records ``ssrl_gemm_f32``'s
    arguments (the wrapper's marshalling, checked without a card)."""

    def __init__(self):
        self.calls = []

    def ssrl_gemm_f32_workspace(self, layout, M, N, K):
        return 256

    def ssrl_gemm_f32(self, *args):
        self.calls.append(args)
        return 0


def test_gemm_f32_dispatch_and_refusals(monkeypatch):
    """At f32 every epilogue's rounding is a no-op: ``gemm_ref`` is the f32
    product with its bias, GELU, GELU derivative or residual (held to an
    f64 product), and ``gemm`` on CPU tensors is ``gemm_ref``. Off the CPU,
    f32 operands go to ``ssrl_gemm_f32`` (meta tensors and a recording
    library: the layout's and epilogue's codes, M, N, K, the buffers each
    epilogue reads and writes, one launch counted) with ``gemm_ref``'s
    outputs' shapes; the wrapper refuses float16, mixed dtypes, an
    epilogue its layout does not take and an empty product, in words."""
    M, N, K = 13, 24, 40
    gelu = torch.nn.functional.gelu
    rng = np.random.default_rng(3)
    rn = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    for layout, epis in bf.GEMM_EPIS.items():
        a = rn(K, M) if layout == "tn" else rn(M, K)
        b = rn(N, K) if layout == "nt" else rn(K, N)
        ex = {"bias": rn(N), "resid": rn(M, N), "z": rn(M, N)}
        ad, bd = a.double(), b.double()
        acc = ad @ bd.t() if layout == "nt" else (ad @ bd if layout == "nn" else ad.t() @ bd)
        for epi in epis:
            out = bf.gemm_ref(a, b, layout, epi, **ex)
            pre = acc + ex["bias"].double()
            zd = ex["z"].double()
            dz = acc * (0.5 * (1 + torch.erf(zd / 2**0.5)) + zd * torch.exp(-zd * zd / 2)
                        / (2 * np.pi) ** 0.5)
            want = {"f32": (acc,), "bf16": (acc,), "bias_bf16": (pre,),
                    "bias_resid": (ex["resid"].double() + pre,),
                    "bias_gelu": (gelu(pre), pre), "bias_gelu32": (gelu(pre), pre),
                    "gelu_bwd": (dz, dz.sum(0)), "gelu32_bwd": (dz, dz.sum(0))}[epi]
            assert len(out) == len(want)
            for got, w in zip(out, want):
                assert got.dtype == torch.float32
                torch.testing.assert_close(got.double(), w, rtol=1e-5, atol=1e-5)
            for got, w in zip(bf.gemm(a, b, layout, epi, **ex), out):
                assert torch.equal(got, w)

    lib = _RecordingLib()
    monkeypatch.setattr(bf._build, "load", lambda: lib)
    monkeypatch.setattr(bf, "_stream", lambda x: 0)
    meta = dict(dtype=torch.float32, device="meta")
    codes = {"nt": 0, "nn": 1, "tn": 2}
    for layout, epis in bf.GEMM_EPIS.items():
        a = torch.empty((K, M) if layout == "tn" else (M, K), **meta)
        b = torch.empty((N, K) if layout == "nt" else (K, N), **meta)
        ex = {"bias": torch.empty(N, **meta), "resid": torch.empty(M, N, **meta),
              "z": torch.empty(M, N, **meta)}
        for epi in epis:
            before = bf.LAUNCHES["gemm_f32"]
            out = bf.gemm(a, b, layout, epi, **ex)
            assert bf.LAUNCHES["gemm_f32"] == before + 1
            args = lib.calls[-1]
            assert args[:2] == (codes[layout], bf._EPI_CODE[epi]) and args[11:14] == (M, N, K)
            # bias, R, Zin, Zout, colsum: given exactly where the epilogue uses them
            present = tuple(p is not None for p in args[5:10])
            gelu, gelu_bwd = epi.startswith("bias_gelu"), epi in ("gelu_bwd", "gelu32_bwd")
            assert present == (epi.startswith("bias"), epi == "bias_resid", gelu_bwd, gelu,
                               gelu_bwd), (layout, epi, present)
            shapes = [tuple(t.shape) for t in out]
            assert shapes == [(M, N)] + ([(M, N)] if gelu else [(N,)] if gelu_bwd else [])
            assert all(t.dtype == torch.float32 for t in out)
    a, b = torch.empty(M, K, **meta), torch.empty(N, K, **meta)
    bias = torch.empty(N, **meta)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bf.gemm(a.half(), b.half(), "nt", "bias_bf16", bias=bias)
    with pytest.raises(TypeError, match="both alike"):
        bf.gemm(a, b.bfloat16(), "nt", "bias_bf16", bias=bias)
    with pytest.raises(ValueError, match="epilogues"):
        bf.gemm(a, b, "nt", "f32")
    with pytest.raises(ValueError, match="M, N, K >= 1"):
        bf.gemm(a[:, :0], b[:, :0], "nt", "bias_bf16", bias=bias)
    with pytest.raises(ValueError, match="disagree"):
        bf.gemm(a, b[:, :4], "nt", "bias_bf16", bias=bias)
    n_calls = len(lib.calls)
    assert n_calls == sum(len(e) for e in bf.GEMM_EPIS.values())
