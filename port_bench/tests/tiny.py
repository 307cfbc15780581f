"""A temporary benchmark root with cells at the test size: the tiny
spatial and FC configurations of the port's registry (16^3 volumes), in
float32 on the CPU, beside the real `port_bench` files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

ACT = {"body_act": "leaky_relu", "negative_slope": 0.2, "decoder_tail_act": "relu",
       "stem_dropout": 0.35, "dec_in_dropout": 0.25, "dec_out_dropout": 0.35}
TINY_SPATIAL = {"name": "tiny_spatial", "source": "sivae_torch MODEL_REGISTRY['tiny_spatial']",
                "family": "spatial", "in_ch": 4, "block_setting": [[4, 1, 2], [8, 2, 2]],
                "input_shape": [16, 16, 16], "act": ACT, "logvar_head_zero_init": True,
                "logvar_clip": [-30.0, 20.0], "param_dtype": "float32",
                "dtype": {"train_step": "float32", "eval_pass": "float32"}, "reduced": []}
TINY_FC = {"name": "tiny_fc", "source": "sivae_torch MODEL_REGISTRY['tiny_fc']", "family": "fc",
           "first_ch": 2, "second_ch": 3, "third_ch": 4, "forth_ch": 5, "z_ch": 7,
           "input_shape": [16, 16, 16],
           "act": dict(ACT, stem_dropout=0.0, dec_in_dropout=0.0, dec_out_dropout=0.0),
           "logvar_head_zero_init": True, "logvar_clip": [-30.0, 20.0],
           "param_dtype": "float32", "dtype": {"train_step": "float32"}, "reduced": []}
LOSS = {"beta_rec": 1.0, "beta_neg": 1024.0, "beta_kl": 0.75, "gamma_r": 1e-8,
        "exp_elbo_weight": 0.5, "loss_multiplier": 10.0}
TRAFFIC = {
    "tiny_train": {"entry": "train_step", "global_batch": 4, "volumes": 12, "lr": 2e-4,
                   "loss": LOSS, "augment": None, "trace_steps": 1},
    "tiny_train_aug": {"entry": "train_step", "global_batch": 4, "volumes": 12, "lr": 2e-4,
                       "loss": dict(LOSS, beta_kl=0.7), "augment": ["affine", 15.0, 0.6],
                       "trace_steps": 1},
    "tiny_eval": {"entry": "eval_pass", "volumes": 20, "encode_batch": 4, "report_batch": 2,
                  "k": 3},
}
# float32 on the CPU against the float32 reference: round-off, amplified
# where BatchNorm normalises few values (tiny_fc's 1x1x1 bottleneck) and in
# the change of a leaf whose gradient is nought but for round-off in a
# second pass of it (the decoder head's 1-channel 1x1 conv before its BN)
TRAIN_LIMITS = {"batch_gap": 1e-5, "loss1_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
EVAL_LIMITS = {"latent_gap": 1e-4, "recon_gap": 1e-4, "report_gap": 1e-4, "knn_gap": 1e-6,
               "precision_gap": 0.0}
CELLS = [("t_train", "tiny_spatial", "tiny_train", 1, TRAIN_LIMITS),
         ("t_fc_train", "tiny_fc", "tiny_train_aug", 1, TRAIN_LIMITS),
         ("t_eval", "tiny_spatial", "tiny_eval", 1, EVAL_LIMITS),
         ("t_dp2", "tiny_spatial", "tiny_train", 2, TRAIN_LIMITS)]


def make_root(tmp: Path) -> Path:
    """A copy of `port_bench/` under `tmp` with the tiny cells added as
    new files and entries, as a later change would add them."""
    root = Path(tmp)
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "port_bench"
    for cfg in (TINY_SPATIAL, TINY_FC):
        (b / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"port_bench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "test size"})
    for name, t in TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, cfg, traffic, chips, limits in CELLS:
        (b / "limits" / f"{name}.json").write_text(json.dumps(limits))
        kind = "train" if traffic != "tiny_eval" else "eval"
        bench["workloads"].append({"name": name, "config": cfg, "traffic": traffic,
                                   "chips": chips, "why": "test size"})
        # the new cell reports what the benchmark's cell of its kind reports
        like = "z1200_train" if kind == "train" else "z1200_eval"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def context(root: Path, cell: str, seed: int = 1234567891011, seconds: float = 0.5,
            trace: int = 0, rank_target=None):
    import time

    from port_bench.harness import make_context, parse

    args = parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)])
    return make_context(root, args, time.perf_counter(), device="cpu", rank_target=rank_target)
