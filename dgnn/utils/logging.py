"""CSV result logging with the reference's schema
(`name,config,train_s,infer_s,maxMB,acc` — test/gat_result.csv)."""

from __future__ import annotations

import os

__all__ = ["append_csv_row"]

_HEADER = (
    "# name,config,train_s_per_epoch,inference_s,peak_MB,test_accuracy\n"
    "# Datasets are SYNTHETIC generators at the real datasets' scale and\n"
    "# statistics (no network egress in this environment — see\n"
    "# dgnn/data/synthetic.py), so accuracies are comparable across\n"
    "# THIS table's rows but not numerically to the reference's records\n"
    "# on the real datasets (e.g. cora GAT: reference 0.9714 on real\n"
    "# Cora, test/gat_result.csv:3; the synthetic task is harder).\n")


def append_csv_row(path: str, name: str, config: str, train_s: float,
                   infer_s: float, max_mb: float, acc: float) -> None:
    header = _HEADER if not os.path.exists(path) else ""
    with open(path, "a") as f:
        f.write(header)
        print(f"{name},{config},{train_s:f}s,{infer_s:f}s,{max_mb:.0f}MB,{acc}",
              file=f)
