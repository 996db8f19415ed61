"""The port's rank-study tools against the JAX package's.

``tools/torch_summarize_rank_study.py`` reads the JAX study's committed
log (``outputs/rank_study``) to the same k-NN, ridge and probe tables as
``tools/summarize_rank_study.py``, and keys each result line by its own
prefix where the JAX copy credits it to the last header. The shell copies
``tools/torch_rank_study{,_cpu}.sh`` keep the JAX study's config heredoc and
stage order, call only the port's CLIs, write outside ``outputs/rank_study``
and stop at the first stage that exits non-zero: they run here against a
stand-in ``python`` on ``PATH`` that records each call.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import stat
import subprocess
import sys
import types
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
JAX_STUDY = REPO / "outputs" / "rank_study"
SHELLS = {"torch_rank_study.sh": "rank_study.sh",
          "torch_rank_study_cpu.sh": "rank_study_cpu.sh"}
# each copy's scale (SSRL_RANK_SCALE) and default epochs, as in its JAX copy
SCALES = {"torch_rank_study.sh": ("card", 20), "torch_rank_study_cpu.sh": ("cpu", 8)}
STUDY = REPO / "tools" / "torch_rank_study.sh"
PORT_CLIS = "ssrl_vit_mae_jepa_torch.scripts."


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = load_tool("torch_summarize_rank_study")
jax_tool = load_tool("summarize_rank_study")


@pytest.mark.parametrize("tool", [port, jax_tool], ids=["port", "jax"])
def test_tables_of_the_jax_study(tool):
    """Both summarizers read the JAX study's log to its k-NN and ridge
    tables (`docs/RESULTS.md`, round 5)."""
    knn, ridge, knn_mean = tool.knn_rows(JAX_STUDY / "study.log")
    assert knn == {"pixels": 0.1405, "random": 0.197, "mae": 0.142, "jepa": 0.22}
    assert ridge == {"pixels": 0.232, "random": 0.492, "mae": 0.679, "jepa": 0.81}
    assert knn_mean == {"mae": 0.1435, "jepa": 0.205, "random": 0.22}


def test_probes_of_the_jax_study():
    want = {n: jax_tool.probe_metrics(JAX_STUDY / "outputs/train" / f"rank_probe_{n}")
            for n in port.PROBES}
    got = port.summary(JAX_STUDY)["probes"]
    assert got == want
    assert all(0.0 < p["best_val_acc"] < 1.0 for p in got.values())


def test_result_lines_keyed_by_their_own_prefix(tmp_path):
    """`knn_eval --eval both` prints a k-NN and a ridge line under one
    header, and a mean-pool k-NN line may sit under a `kNN` header. The
    JAX copy credits each line to the last header, so the ridge line
    overwrites the k-NN one: that is why the port's copy keys each line by
    its prefix and pool."""
    log = tmp_path / "study.log"
    log.write_text(
        "=== kNN jepa Wed Aug 19 12:28:07 UTC 2026 ===\n"
        "kNN(k=20, T=0.07, pool=cls, train=4000) test accuracy: 0.3000\n"
        "ridge(lam=10, pool=cls, train=4000) test accuracy: 0.7000\n"
        "=== kNN mae Wed Aug 19 12:30:07 UTC 2026 ===\n"
        "kNN(k=20, T=0.07, pool=mean, train=4000) test accuracy: 0.1500\n")
    assert port.knn_rows(log) == ({"jepa": 0.3}, {"jepa": 0.7}, {"mae": 0.15})
    assert jax_tool.knn_rows(log) == ({"jepa": 0.7, "mae": 0.15}, {}, {})


def study_copy(tmp_path: Path, drop_line: str = "", drop_probe: str = "") -> Path:
    """The JAX study's log and probe metrics under ``tmp_path``, less one
    result line (the first containing ``drop_line``) or one probe run."""
    out = tmp_path / "study"
    lines = (JAX_STUDY / "study.log").read_text().splitlines(keepends=True)
    if drop_line:
        lines.remove(next(ln for ln in lines if drop_line in ln))
    out.mkdir()
    (out / "study.log").write_text("".join(lines))
    for n in port.PROBES:
        if n != drop_probe:
            run = out / "outputs/train" / f"rank_probe_{n}"
            run.mkdir(parents=True)
            shutil.copy(JAX_STUDY / "outputs/train" / f"rank_probe_{n}" / "metrics.jsonl", run)
    return out


@pytest.mark.parametrize("drop, missing", [
    ({}, ""),
    ({"drop_line": "ridge(lam=10, pool=cls, train=4000) test accuracy: 0.6790"}, "ridge mae"),
    ({"drop_line": "pool=cls, train=4000) test accuracy: 0.1405"}, "knn pixels"),
    ({"drop_probe": "jepa"}, "probe jepa"),
], ids=["complete", "no-ridge-row", "no-knn-row", "no-probe"])
def test_main_exits_nonzero_on_a_missing_row(tmp_path, capsys, drop, missing):
    out = study_copy(tmp_path, **drop)
    rc = port.main([str(out)])
    captured = capsys.readouterr()
    assert captured.out.splitlines()[-1].startswith('{"knn": ')
    if missing:
        assert rc != 0
        assert f"missing rows: {missing}" in captured.err
    else:
        assert rc == 0 and captured.err == ""


def heredoc(text: str) -> dict:
    """The config heredoc of a JAX study script, parsed, with ``$EPOCHS``
    and ``logging.output_dir_base`` set aside."""
    body = re.search(r'cat > "\$CFG" <<EOF\n(.*?)\nEOF\n', text, re.S).group(1)
    cfg = yaml.safe_load(body.replace("$EPOCHS", "EPOCHS"))
    del cfg["logging"]["output_dir_base"]
    return cfg


def flags(words: list) -> dict:
    """The ``--flag value`` pairs of a command line."""
    return {w: v for w, v in zip(words, words[1:]) if w.startswith("--")}


def jax_eval_flags(text: str, cfg: Path, data: Path) -> dict:
    """The flags of the JAX script's first k-NN call (raw pixels), with its
    shell variables resolved."""
    call = re.search(r"knn_eval(.*?)>>", text, re.S).group(1).replace("\\\n", " ")
    for var, value in (('"$CFG"', cfg), ('"$ckpt"', "pixels"), ('"$DATA"', data)):
        call = call.replace(var, str(value))
    return flags(call.split())


def stage_kinds(text: str) -> list:
    """The `=== <kind>` headers the script writes, in order."""
    return re.findall(r'echo "=== ([\w-]+(?: [\w$]+)?)', text)


@pytest.mark.parametrize("copy", sorted(SHELLS))
def test_shell_copy_keeps_the_jax_protocol(tmp_path, copy):
    """Each copy, run against the stand-in ``python``, writes the JAX
    copy's config heredoc at its scale and runs the JAX copy's evals at its
    settings; the one study script calls only the port's CLIs, stops on
    errors, keeps the JAX stage order and timeouts and writes outside
    ``outputs/rank_study`` by default."""
    scale, epochs = SCALES[copy]
    rc, calls, _ = run_with_stand_in(tmp_path, copy)
    assert rc == 0
    out, jax_text = tmp_path / "out", (REPO / "tools" / SHELLS[copy]).read_text()
    cfg = yaml.safe_load((out / "study_cfg.yaml").read_text())
    for section in ("pretrain", "jepa"):
        assert cfg[section]["total_epochs"] == epochs
        cfg[section]["total_epochs"] = "EPOCHS"
    assert cfg["logging"].pop("output_dir_base") == str(out / "outputs")
    assert cfg == heredoc(jax_text)
    knn = next(c.split() for c in calls if "knn_eval" in c)
    assert flags(knn) == jax_eval_flags(jax_text, out / "study_cfg.yaml", tmp_path / "data")

    text = STUDY.read_text()
    modules = re.findall(r"python -m (\S+)", text)
    assert modules and all(m.startswith(PORT_CLIS) for m in modules)
    assert [m[len(PORT_CLIS):] for m in modules] == [
        "data", "training.pretrain_mae", "training.pretrain_jepa"
    ] + ["evaluation.knn_eval"] * 3 + ["training.train_mae"] * 2
    assert re.search(r"^set -euo pipefail$", text, re.M)
    assert "JAX_PLATFORMS" not in text + (REPO / "tools" / copy).read_text()
    default = Path(re.search(rf"^  {scale}\)\s+OUT=\$\{{SSRL_RANK_OUT:-(\S+)\}}$",
                             text, re.M).group(1))
    assert default.parts[:1] == ("outputs",)
    assert not default.is_relative_to(Path("outputs/rank_study"))
    assert default.name != "rank_study_cpu"
    extra = ["stage failed", "ridge $name", "kNN-mean $name"]
    kinds = stage_kinds(text)
    assert [k for k in kinds if k not in extra] == stage_kinds(jax_text)
    assert kinds.index("ridge $name") == kinds.index("kNN $name") + 1
    assert kinds.index("kNN-mean $name") == kinds.index("ridge $name") + 1
    timeouts = dict(re.findall(r"timeout (\d+) python -m \S+\.(\w+)", text))
    assert timeouts == dict(re.findall(r"timeout (\d+) python -m \S+\.(\w+)", jax_text))


def run_with_stand_in(tmp_path: Path, copy: str, fail_module: str = "", **env_extra) -> tuple:
    """Run a study script with a stand-in ``python`` that records its
    arguments and exits 1 for ``fail_module``, 0 otherwise → (exit code,
    recorded calls, the study log)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    stub = bin_dir / "python"
    stub.write_text('#!/bin/bash\necho "$*" >> "$STUDY_CALLS"\n'
                    '[ -n "$FAIL_MODULE" ] && [[ "$*" == *"$FAIL_MODULE"* ]] && exit 1\n'
                    "exit 0\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "out"
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}",
           "STUDY_CALLS": str(calls), "FAIL_MODULE": fail_module,
           "SSRL_RANK_OUT": str(out), "SSRL_RANK_DATA": str(tmp_path / "data"), **env_extra}
    proc = subprocess.run(["bash", str(REPO / "tools" / copy)], env=env,
                          capture_output=True, text=True, timeout=60)
    recorded = calls.read_text().splitlines() if calls.exists() else []
    log = out / "study.log"
    return proc.returncode, recorded, log.read_text() if log.exists() else ""


@pytest.mark.parametrize("copy", sorted(SHELLS))
def test_shell_copy_runs_each_eval_once(tmp_path, copy):
    rc, calls, log = run_with_stand_in(tmp_path, copy)
    assert rc == 0
    assert len(calls) == 17 and all(c.startswith("-m " + PORT_CLIS) for c in calls)
    ridge = [c.split() for c in calls if "--eval ridge" in c]
    ckpts = [c[c.index("--checkpoint") + 1] for c in ridge]
    lams = [c[c.index("--ridge_lam") + 1] for c in ridge]
    assert ckpts[:2] == ["pixels", "random"] and lams == ["1000", "10", "10", "10"]
    assert [Path(c).parts[-3:] for c in ckpts[2:]] == [
        (f"rank_{n}", "checkpoints", "best.ckpt") for n in ("mae", "jepa")]
    assert sum("--pool mean" in c for c in calls) == 3
    assert not any("--eval both" in c for c in calls)
    assert log.splitlines()[-1].startswith("=== rank study")
    assert "stage failed" not in log


@pytest.mark.parametrize("fail_module", ["training.pretrain_jepa", "--eval ridge"])
def test_shell_copy_stops_at_the_first_failed_stage(tmp_path, fail_module):
    rc, calls, log = run_with_stand_in(tmp_path, "torch_rank_study.sh", fail_module)
    assert rc == 1
    assert fail_module in calls[-1]
    assert log.splitlines()[-1].startswith("=== stage failed (exit 1)")
    assert "=== probe" not in log and "=== rank study done" not in log


def test_shell_copy_refuses_a_used_out(tmp_path):
    """A second run into one directory would append to its study.log and
    metrics.jsonl files, and the summary would mix the two runs."""
    (tmp_path / "out").mkdir()
    (tmp_path / "out" / "study.log").write_text("=== an earlier run ===\n")
    rc, calls, log = run_with_stand_in(tmp_path, "torch_rank_study.sh")
    assert rc == 2 and calls == []
    assert log == "=== an earlier run ===\n"
    assert not (tmp_path / "out" / "study_cfg.yaml").exists()


@pytest.mark.parametrize("seed", ["", "74"], ids=["config-seed", "seed-74"])
def test_shell_copy_takes_a_seed(tmp_path, seed):
    rc, _, _ = run_with_stand_in(tmp_path, "torch_rank_study.sh", SSRL_RANK_SEED=seed)
    assert rc == 0
    cfg = yaml.safe_load((tmp_path / "out" / "study_cfg.yaml").read_text())
    assert cfg.get("seed") == (int(seed) if seed else None)



def test_cli_processes_append_their_launches(tmp_path, monkeypatch):
    """``SSRL_LAUNCH_LOG``: each CLI process appends its nonzero launch
    counters at exit, which is how the chip smoke sums the study's."""
    from ssrl_vit_mae_jepa_torch import scripts

    wrapper = types.SimpleNamespace(LAUNCHES={"attn_branch_fwd": 3, "attn_branch_bwd": 0})
    monkeypatch.setitem(sys.modules, "ssrl_vit_mae_jepa_torch.ops.block_fused", wrapper)
    log = tmp_path / "launches.jsonl"
    scripts.write_launches(str(log))
    scripts.write_launches(str(log))
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(records) == 2
    assert all(r["launches"] == {"attn_branch_fwd": 3} for r in records)
