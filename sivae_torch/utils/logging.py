"""Structured metrics logging: CSV + append-style txt logs + stdout lines.

The port's own copy of `sivae_tpu/utils/logging.py:21-80`, writing the same
files byte for byte (so `tools/plot_run.py` and `tools/run_health.py` read
port runs), the reference's observability surface (SURVEY §5):
- train_result.csv with per-epoch loss columns (my_trainer.py:162-165)
- loss.txt (trainE/valE/trainD/valD lines, write_fig :522-529)
- kl_losses.txt (kls_real/fake/rec + rec_errs, write_kl_losses :531-538)
- train_losses.txt / val_losses.txt (mse+kl pairs, :541-546)
- stdout epoch lines with Rec/KL/expELBO/DIFF_KL and wall-clock
plus metrics.jsonl, one machine-readable record per epoch.

Under data parallelism every rank keeps the history (the epoch means are
the same on every rank) and only rank 0 writes the files: one set per run.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional

from sivae_torch.parallel.distributed import is_main_process


class MetricsLogger:
    def __init__(self, run_dir: str, csv_columns: Optional[List[str]] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.csv_path = os.path.join(run_dir, "train_result.csv")
        self.jsonl_path = os.path.join(run_dir, "metrics.jsonl")
        self.columns = csv_columns or [
            "epoch", "train_lossE", "train_lossD", "val_lossE", "val_lossD"]
        self.writes = is_main_process()
        if self.writes:
            with open(self.csv_path, "w", newline="") as f:
                csv.writer(f).writerow(self.columns)
        self.history: Dict[str, List[float]] = {}
        self.start_time = time.time()

    def append(self, **metrics: float) -> None:
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def write_epoch(self, epoch: int, row: Dict[str, float]) -> None:
        if not self.writes:
            return
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [epoch] + [row.get(c, float("nan")) for c in self.columns[1:]])
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "time": time.time() - self.start_time,
                                **{k: float(v) for k, v in row.items()}}) + "\n")

    # --- reference-format txt dumps (rewritten whole each epoch) ---------
    def write_loss_txt(self) -> None:
        if not self.writes:
            return
        h = self.history
        with open(os.path.join(self.run_dir, "loss.txt"), "w") as f:
            for te, ve, td, vd in zip(h.get("train_lossE", []), h.get("val_lossE", []),
                                      h.get("train_lossD", []), h.get("val_lossD", [])):
                f.write(f"trainE={te}\nvalE==={ve}\ntrainD={td}\nvalD==={vd}\n")

    def write_kl_txt(self) -> None:
        if not self.writes:
            return
        h = self.history
        with open(os.path.join(self.run_dir, "kl_losses.txt"), "w") as f:
            for a, b, c, d in zip(h.get("kls_real", []), h.get("kls_fake", []),
                                  h.get("kls_rec", []), h.get("rec_errs", [])):
                f.write(f"kls_real=={a}\nkls_fake=={b}\nkls_rec==={c}\nrec_errs=={d}\n")

    def write_mse_kl_txt(self, name: str, mse_key: str, kl_key: str) -> None:
        if not self.writes:
            return
        h = self.history
        with open(os.path.join(self.run_dir, name), "w") as f:
            for m, k in zip(h.get(mse_key, []), h.get(kl_key, [])):
                f.write(f"mse_loss=={m}\nkl_loss==={k}\n")

    def epoch_line(self, epoch: int, epochs: int, train: Dict[str, float],
                   val: Dict[str, float], epoch_seconds: float) -> str:
        total_min = (time.time() - self.start_time) / 60
        return (
            f"Epoch[{epoch + 1}/{epochs}] "
            f"train_lossE:{train.get('lossE', float('nan')):.3f} "
            f"train_lossD:{train.get('lossD', float('nan')):.3f} "
            f"val_lossE:{val.get('lossE', float('nan')):.3f} "
            f"val_lossD:{val.get('lossD', float('nan')):.3f} | "
            f"Train[RMSE:{train.get('rmse', float('nan')):.5f} "
            f"kl:{train.get('rec_kl', float('nan')):.1f}] "
            f"Val[RMSE:{val.get('rmse', float('nan')):.5f}] "
            f"epoch:{epoch_seconds:.0f}s total:{total_min:.0f}min"
        )
