"""Summarize a run of the port's rank study (tools/torch_rank_study{,_cpu}.sh)
into one table.

Parses the study log for the four encoders' rows (`=== kNN <name>`,
`=== ridge <name>`, `=== kNN-mean <name>` headers) and reads each probe
run's best validation accuracy from its metrics.jsonl, then prints a
markdown table plus one JSON line; a first JSON line gives each stage's
wall seconds (from one `date -u` header to the next) and each pretraining
run's epoch times and img/s (its metrics.jsonl). Each result line goes to
the table its own prefix names -- `kNN(... pool=cls ...)` to k-NN,
`kNN(... pool=mean ...)` to kNN-mean, `ridge(` to ridge -- and the
encoder's name comes from the last header, so a section that prints both a k-NN and a ridge line
(`knn_eval --eval both`) fills both tables. Exits non-zero when a cls
k-NN or ridge row of the four encoders, or a probe of the three, is
missing: an empty cell is not a result.

Usage: python tools/torch_summarize_rank_study.py [outputs/torch_rank_study_cpu]
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path

ENCODERS = ("pixels", "random", "mae", "jepa")
PROBES = ("random", "mae", "jepa")
HEADER = re.compile(r"=== (kNN-mean|kNN|ridge) (\w+) ")
RESULT = re.compile(r"(kNN|ridge)\((.*)\) test accuracy: ([0-9.]+)")
STAGE = re.compile(r"=== (.+?) \w{3} \w{3} +\d+ (\d\d):(\d\d):(\d\d) UTC \d{4} ===$")


def table_of(prefix: str, args: str) -> str:
    """The table a result line belongs to, from its own prefix and pool."""
    if prefix == "ridge":
        return "ridge"
    return "kNN-mean" if re.search(r"\bpool=mean\b", args) else "kNN"


def knn_rows(log_path: Path) -> tuple[dict, dict, dict]:
    """(knn, ridge, knn_mean) accuracy by encoder, parsed from the study
    log: the encoder is the last header's, the table the result line's."""
    tables = {"kNN": {}, "ridge": {}, "kNN-mean": {}}
    name = None
    for line in log_path.read_text(errors="replace").splitlines():
        m = HEADER.match(line)
        if m:
            name = m.group(2)
        m = RESULT.search(line)
        if m and name:
            tables[table_of(m.group(1), m.group(2))][name] = float(m.group(3))
    return tables["kNN"], tables["ridge"], tables["kNN-mean"]


def probe_metrics(run_dir: Path) -> dict:
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return {}
    best_val = None
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        for key in ("val_accuracy", "val_acc", "val_top1"):
            if key in rec:
                v = float(rec[key])
                best_val = v if best_val is None else max(best_val, v)
    return {"best_val_acc": best_val}


def stage_seconds(log_path: Path) -> dict:
    """Wall seconds of each stage, from its header's `date -u` to the next
    header's (whole seconds; the stage's name is the header's text)."""
    marks = []
    for line in log_path.read_text(errors="replace").splitlines():
        m = STAGE.match(line)
        if m:
            h, mi, s = map(int, m.group(2, 3, 4))
            marks.append((m.group(1), 3600 * h + 60 * mi + s))
    return {name: (t1 - t0) % 86400 for (name, t0), (_, t1) in zip(marks, marks[1:])}


def pretrain_rates(out: Path) -> dict:
    """Per pretraining run: its epochs, the first epoch's seconds (compile
    and warm-up included) and the median seconds and img/s of the others."""
    rates = {}
    for name in ("mae", "jepa"):
        path = out / "outputs/pretrain" / f"rank_{name}" / "metrics.jsonl"
        if not path.exists():
            continue
        recs = [r for r in map(json.loads, path.read_text().splitlines())
                if "epoch_time_s" in r]
        if not recs:
            continue
        rest = recs[1:] or recs
        rates[name] = {"epochs": len(recs), "first_epoch_s": recs[0]["epoch_time_s"],
                       "epoch_s": statistics.median(r["epoch_time_s"] for r in rest),
                       "images_per_s": statistics.median(r["images_per_s"] for r in rest)}
    return rates


def summary(out: Path) -> dict:
    """The study's tables and probes, as the JSON line prints them."""
    knn, ridge, knn_mean = knn_rows(out / "study.log")
    probes = {name: probe_metrics(out / "outputs/train" / f"rank_probe_{name}")
              for name in PROBES}
    return {"knn": knn, "ridge": ridge, "knn_mean": knn_mean, "probes": probes}


def missing_rows(s: dict) -> list:
    """The required cells that are empty: cls k-NN and ridge of the four
    encoders, the probes of the three."""
    return ([f"knn {n}" for n in ENCODERS if n not in s["knn"]]
            + [f"ridge {n}" for n in ENCODERS if n not in s["ridge"]]
            + [f"probe {n}" for n in PROBES
               if s["probes"][n].get("best_val_acc") is None])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0] if argv else "outputs/torch_rank_study_cpu")
    s = summary(out)
    print(json.dumps({"stage_s": stage_seconds(out / "study.log"),
                      "pretrain": pretrain_rates(out)}))

    def cell(v):
        return "" if v is None else f"{v:.1%}"

    print("| encoder | k-NN top-1 | ridge probe top-1 | adam probe best-val |")
    print("|---|---|---|---|")
    for name in ENCODERS:
        p = s["probes"].get(name, {}).get("best_val_acc")
        print(f"| {name} | {cell(s['knn'].get(name))} | {cell(s['ridge'].get(name))} | "
              f"{cell(p)} |")
    print()
    print(json.dumps(s))
    missing = missing_rows(s)
    if missing:
        print(f"{out}: missing rows: {', '.join(missing)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
