#!/usr/bin/env python3
"""The f32 whole block and chain of two or more checkouts of the PyTorch
port, side by side on one NVIDIA GPU, by device time.

Each TREE is a checkout root that holds ``ssrl_vit_mae_jepa_torch/`` (``.``
for this one; a parent as ``git archive <commit> | tar -x -C build/parent``).
The kernels of every tree are built first, all at once, each into its own
``build/torch_kernels/``; then one process per TREE, in the order given
(parent, change, change, parent to see the drift), imports that tree's
package and this checkout's ``chip_smoke.py`` (its inputs, split stack and
profiler helpers: ``stack_inputs``, ``split_stack``, ``device_ms``,
``call_launches``) and prints one ``AB`` JSON line: per call, the device ms
and kernel launches of the f32 whole block, the f32 chain and the split f32
branches on the same blocks (rows 1 + 4, 2 + 5), forward and backward, at
the MAE encoder and decoder and the JEPA target encoder (no grad) at B=768,
TF32 off; their sums per MAE step (4 encoder and 2 decoder blocks) and per
JEPA target encoder; and the device ms and peak device memory of one f32
MAE and one f32 JEPA step on the chain with the fused embed
(``chip_smoke.f32_chain_step``). Needs a GPU::

    python3 tools/torch_f32_stack_ab.py build/parent . . build/parent

It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
# (L, D, H, chain depth): the MAE encoder and decoder, the JEPA target
# encoder (no grad); calls per MAE step or JEPA target encoder by kind
GEOS = {"enc": (37, 144, 6, 4), "dec": (145, 192, 6, 2), "tgt": (145, 144, 6, 4)}
CALLS = {"block": {"enc": 4, "dec": 2, "tgt": 4}, "split": {"enc": 4, "dec": 2, "tgt": 4},
         "chain": dict.fromkeys(GEOS, 1)}


def worker(root: pathlib.Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    bf, bc = cs.bf, cs.bc
    assert pathlib.Path(bf.__file__).resolve().is_relative_to(root.resolve()), bf.__file__
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cs._build.load()

    def profile(fn):
        return cs.device_ms(fn), sum(cs.call_launches(fn, lambda c: True).values())

    res = {}
    for geo, (L, D, H, depth) in GEOS.items():
        grad = geo != "tgt"
        for kind in CALLS:
            N = depth if kind == "chain" else 1
            x, dy, params = cs.stack_inputs(L, D, N, L + D + N, torch.float32)
            kern = {"block": lambda x, pl: bf.fused_block(x, pl[0], H),
                    "chain": lambda x, pl: bc.fused_block_chain(x, pl, H),
                    "split": lambda x, pl: cs.split_stack(x, pl, H)}[kind]
            if grad:
                xl = x.clone().requires_grad_()
                pl = [[t.clone().requires_grad_() for t in p] for p in params]
                leaves = [xl] + [t for p in pl for t in p]
                out = kern(xl, pl)
                res[f"{kind}_{geo}"] = {
                    "fwd": profile(lambda: kern(xl, pl)),
                    "bwd": profile(lambda: torch.autograd.grad(out, leaves, dy,
                                                               retain_graph=True))}
                del out, xl, pl, leaves
            else:
                with torch.no_grad():
                    res[f"{kind}_{geo}"] = {"fwd": profile(lambda: kern(x, params))}
            del x, dy, params
            torch.cuda.empty_cache()
    step = {}
    for kind, calls in CALLS.items():
        for pas in ("fwd", "bwd"):
            for i, what in ((0, ""), (1, "_launches")):
                step[f"{kind}_{pas}_mae{what}"] = sum(
                    calls[g] * res[f"{kind}_{g}"][pas][i] for g in ("enc", "dec"))
        step[f"{kind}_fwd_tgt"] = calls["tgt"] * res[f"{kind}_tgt"]["fwd"][0]
    res["per_step"] = step
    res["chain_steps"] = {t: cs.f32_chain_step(t) for t in ("mae", "jepa")}
    print("AB", root, json.dumps(res), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(pathlib.Path(sys.argv[2]))
        return
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        raise SystemExit(__doc__)
    roots = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
    t0 = time.perf_counter()
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from ssrl_vit_mae_jepa_torch import _build; _build.build()")
    builds = [subprocess.Popen([sys.executable, "-c", build, str(r)])
              for r in dict.fromkeys(roots)]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    print(f"built {len(builds)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    for r in roots:
        subprocess.run([sys.executable, __file__, "--worker", str(r)], check=True)


if __name__ == "__main__":
    main()
