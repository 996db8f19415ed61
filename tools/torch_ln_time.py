#!/usr/bin/env python3
"""Device time of the port's LayerNorm kernels and of the model-axis finish,
on one NVIDIA GPU.

At B=768 and each block geometry of ``chip_smoke.GEOMETRIES`` that trains
(``enc``, ``ctx``, ``dec``, ``pred``, ``cls``), times under ``torch.profiler``
one call of:

- ``block_fused.branch_ln_bwd`` at bf16 and at f32 (the LayerNorm backward
  that ends every branch backward), beside the nearest library call,
  ``torch.ops.aten.native_layer_norm_backward`` on the same x and dy with
  the mean and rstd of an untimed ``native_layer_norm`` (it computes less:
  no residual gradient, no sum of gy, the statistics given);
- ``block_fused.branch_finish`` at bf16 (``bf16(x + bf16(s + b))``);
- the LayerNorm forward inside a no-grad attention branch forward (its
  ``ln_fwd_kernel`` share), beside ``torch.nn.functional.layer_norm`` on the
  same x, scale and bias;

each with its bound: the bytes it must move (inputs read once, outputs
written once) over 3.35 TB/s. Device time sums the kernels (and memsets)
of one call (the larger of two profiler sessions); ``kernels`` counts the
kernel launches a call makes. Then,
unless ``--no-steps``, the MAE step on ``auto`` at bf16 and at f32 under
``torch.profiler``: device ms a step, and the LayerNorm kernels' and
``colsum_kernel``'s ms and launches a step.

The package timed is the one beside this file, so a copy of the script in
an older checkout times that checkout's kernels::

    python3 tools/torch_ln_time.py --out build/ln_time.json

It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import PRE_CFG, branch_inputs, card, flagship_images  # noqa: E402
from ssrl_vit_mae_jepa_torch import _build  # noqa: E402
from ssrl_vit_mae_jepa_torch.config import load_config  # noqa: E402
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf  # noqa: E402
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask  # noqa: E402
from ssrl_vit_mae_jepa_torch.utils.profiling import device_us  # noqa: E402

BATCH = 768
GEOS = {"enc": (37, 144, 6), "ctx": (45, 144, 6), "dec": (145, 192, 6),
        "pred": (145, 96, 6), "cls": (145, 144, 6)}
PEAK_BYTES = 3.35e12
ITERS = 20


def session(fn, iters: int):
    """One profiler session of ``iters`` calls: (device ms a call, kernel
    name -> (ms, launches) a call), or None where it recorded nothing."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in evts)
    if total <= 0:
        return None
    return total / 1e3 / iters, {e.key: (device_us(e) / 1e3 / iters, e.count / iters)
                                 for e in evts}


def profiled(fn, iters: int = ITERS) -> tuple:
    """(device ms, kernel launches, name -> (ms, launches)) of one call of
    ``fn`` after a warm-up call: the larger of two sessions of ``iters``
    calls that recorded device time (a session now and then records
    nothing, or loses kernels and reads low)."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(8):
        r = session(fn, iters)
        if r is not None:
            got.append(r)
        if len(got) == 2:
            break
    if not got:
        raise RuntimeError("torch.profiler recorded no device time in 8 sessions")
    ms, kern = max(got, key=lambda r: r[0])
    launches = sum(n for k, (_, n) in kern.items() if not k.startswith("Memset"))
    return ms, launches, kern


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES * 1e3


def geometry(geo: str) -> dict:
    L, D, H = GEOS[geo]
    M = BATCH * L
    g = torch.Generator().manual_seed(L + D)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x32 = rn(M, D).cuda()
    s = (1.0 + 0.1 * rn(D)).cuda()
    b = (0.1 * rn(D)).cuda()
    dy = rn(M, D).cuda()
    gy32 = rn(M, D).cuda()
    part = rn(M, D).cuda()
    x, gy = x32.bfloat16(), gy32.bfloat16()
    r = {"M": M, "D": D}

    def put(name, fn, nbytes):
        ms, n, kern = profiled(fn)
        r[name] = {"device_ms": ms, "kernels": n, "bound_ms": bound_ms(nbytes),
                   "by_kernel": kern}

    e = M * D
    put("ln_bwd_bf16", lambda: bf.branch_ln_bwd(x, s, dy, gy), 10 * e)
    put("ln_bwd_f32", lambda: bf.branch_ln_bwd(x32, s, dy, gy32), 16 * e)
    b16 = b.bfloat16()
    put("finish_bf16", lambda: bf.branch_finish(x, part, b16), 8 * e)
    for name, xx, dyx in (("library_ln_bwd_bf16", x, dy.bfloat16()), ("library_ln_bwd_f32",
                                                                      x32, dy)):
        _, mean, rstd = torch.ops.aten.native_layer_norm(xx, [D], s.to(xx.dtype),
                                                         b.to(xx.dtype), 1e-6)
        w, bb = s.to(xx.dtype), b.to(xx.dtype)
        put(name, lambda: torch.ops.aten.native_layer_norm_backward(
            dyx, xx, [D], mean, rstd, w, bb, [True, True, True]),
            (6 if xx.dtype == torch.bfloat16 else 12) * e)
    s16 = s.bfloat16()
    put("library_ln_fwd_bf16", lambda: torch.nn.functional.layer_norm(x, (D,), s16, b16, 1e-6),
        4 * e)
    xb, _, params = branch_inputs("attn", L, D, seed=L + D)
    with torch.no_grad():
        _, _, kern = profiled(lambda: bf.fused_attn_branch(xb, *params, H))
    ln = [(ms, n) for k, (ms, n) in kern.items() if "ln_fwd" in k]
    r["ln_fwd_bf16"] = {"device_ms": sum(ms for ms, _ in ln) / max(1, sum(n for _, n in ln)),
                        "kernels": 1, "bound_ms": bound_ms(4 * e)}
    return r


def step(dtype) -> dict:
    cfg = load_config(REPO / "configs" / "mae.yaml")
    task = MAETask(cfg["model"], PRE_CFG, dtype=dtype, device="cuda", attn_impl="auto")
    state = task.init_state(0)
    data = flagship_images()
    ctx = task.epoch_context(0)
    steps = 3
    for _ in range(3):
        state, _ = task.train_step(state, data, 0, ctx)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = task.train_step(state, data, 0, ctx)
        torch.cuda.synchronize()
    kern = {e.key: (device_us(e) / 1e3 / steps, e.count / steps) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
    pick = {k: v for k, v in kern.items()
            if any(t in k for t in ("ln_bwd", "ln_fwd", "ln_f32", "colsum"))}
    return {"device_ms": sum(ms for ms, _ in kern.values()),
            "ln_kernels": {k: {"ms": ms, "calls": n} for k, (ms, n) in pick.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-steps", action="store_true", help="skip the MAE step profiles")
    ap.add_argument("--out", type=pathlib.Path, help="also write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this timing needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    out = {"card": card(), "repo": str(REPO), "geometries": {}, "steps": {}}
    print(out["card"], REPO, flush=True)
    for geo in GEOS:
        r = out["geometries"][geo] = geometry(geo)
        for k, v in r.items():
            if isinstance(v, dict):
                print(f"  {geo} M={r['M']} D={r['D']} {k}: {v['device_ms']:.4f} ms, "
                      f"{v['kernels']:.0f} kernels, bound {v['bound_ms']:.4f} "
                      f"({100 * v['bound_ms'] / v['device_ms']:.1f}%)", flush=True)
    if not args.no_steps:
        for name, dt in (("mae_bf16", torch.bfloat16), ("mae_f32", torch.float32)):
            r = out["steps"][name] = step(dt)
            print(f"  {name} auto: {r['device_ms']:.3f} device ms/step", flush=True)
            for k, v in sorted(r["ln_kernels"].items(), key=lambda kv: -kv[1]["ms"]):
                print(f"    {v['ms']:.4f} ms/step {v['calls']:6.1f} calls  {k[:100]}")
            torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
