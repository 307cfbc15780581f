"""The algorithm's multiplications, counted from the plain reference by
`torch.utils.flop_counter.FlopCounterMode` on the meta device (nothing is
computed): convolutions, their two gradients and the Linears' products.
The port's own kernels are invisible to the counter, so the count is the
reference's, and a later change of kernels leaves it alone."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.model import make_reference
from port_bench.reference.step import RefTrainer, StepHyper


def _meta_model(cfg: dict):
    return make_reference(cfg, "meta")


def train_step_flops(cfg: dict, hp: StepHyper, batch: int) -> float:
    """One two-phase step at `batch` rows: 13 forwards, phase E's backward
    to the encoder and phase D's to the decoder, as the reference runs it."""
    model = _meta_model(cfg)
    trainer = RefTrainer(model, hp, seed=0, steps_per_epoch=1, scale=1.0, meta=True)
    real = torch.zeros((batch, 1) + tuple(cfg["input_shape"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        trainer.step(real)
    return float(counter.get_total_flops())


def eval_pass_flops(cfg: dict, volumes: int, encode_batch: int, report_volumes: int,
                    report_batch: int) -> float:
    """One eval pass: `volumes` encoded in batches of `encode_batch` (the
    tail padded, as the program pads it) and `report_volumes` encoded and
    decoded in batches of `report_batch`."""
    from port_bench.reference.evaluate import encode_mu, reconstruct
    from port_bench.reference.model import Precision

    model = _meta_model(cfg)
    shape = (1,) + tuple(cfg["input_shape"])
    with FlopCounterMode(display=False) as enc:
        encode_mu(model, torch.zeros((encode_batch,) + shape, device="meta"), Precision())
    with FlopCounterMode(display=False) as rec:
        reconstruct(model, torch.zeros((report_batch,) + shape, device="meta"), Precision())
    n_enc = -(-volumes // encode_batch)
    n_rec = -(-report_volumes // report_batch)
    return float(enc.get_total_flops() * n_enc + rec.get_total_flops() * n_rec)
