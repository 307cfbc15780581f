"""The JAX package's FC Soft-IntroVAE step on `data x spatial` meshes of CPU
devices against the same step on one device.

GSPMD partitions a jitted step without changing what it computes, so every
mesh should give the one-device step's result to fp32 rounding. For
`tiny_fc` at input (32, 16, 16) (a (2, 1, 1) bottleneck), global batch 4,
zero eps and a fixed noise batch, from the port's seeded init with random
BN statistics (as tests/test_torch_depth_fc.py builds it), this prints, for
each mesh shape, the relative difference of the metrics and the largest
relative difference of any Adam first-moment tensor (tensors above 1e-3 of
the largest moment), against one device. The port's depth-sharded FC step
is held to the mesh shapes that agree with one device.

Usage: python tools/jax_fc_mesh_check.py   (the CPU, 8 host devices)
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sivae_tpu.train.step as jax_step  # noqa: E402
from sivae_tpu.config import OptimConfig, SoftIntroLossConfig  # noqa: E402
from sivae_tpu.models.registry import make_model as jax_make_model  # noqa: E402
from sivae_tpu.parallel import mesh as jax_mesh  # noqa: E402
from sivae_torch.models.registry import make_model  # noqa: E402
from test_torch_depth_fc import _carried, _jax_cfg  # noqa: E402
from torch_depth_fc_worker import BATCH, FC_SHAPE, fc_cfg  # noqa: E402
from torch_port_common import flat_state, jax_state_trees  # noqa: E402

MESHES = ((2, 1), (1, 2), (2, 2))


def main():
    rng = np.random.RandomState(21)
    real = rng.rand(BATCH, *FC_SHAPE, 1).astype(np.float32)
    fixed = rng.randn(BATCH, fc_cfg().z_ch).astype(np.float32)
    model_j = jax_make_model(_jax_cfg("tiny_fc", input_shape=FC_SHAPE))
    _, st, _, _ = _carried(make_model(fc_cfg(), device="cpu"), model_j, FC_SHAPE)
    step = jax.jit(jax_step.make_soft_intro_train_step(
        model_j, SoftIntroLossConfig(), OptimConfig(), 1, FC_SHAPE, zero_noise=True,
        fixed_noise=fixed))
    st1, m1 = step(st, jnp.asarray(real))
    one = flat_state(jax_state_trees(st1))
    moments = [k for k in one if k.startswith(("opt_e/mu/", "opt_d/mu/"))]
    top = max(np.abs(one[k]).max() for k in moments)
    for shape in MESHES:
        mesh = jax_mesh.make_mesh(shape, ("data", "spatial"))
        st2, m2 = step(jax_mesh.replicate_state(st, mesh),
                       jax_mesh.shard_batch(real, mesh, spatial_axis="spatial"))
        got = flat_state(jax_state_trees(st2))
        rel = {k: abs(float(m2[k]) - float(m1[k])) / abs(float(m1[k]))
               for k in ("lossE", "lossD", "kl_real", "rec_kl", "fake_kl")}
        worst = max((float(np.abs(got[k] - one[k]).max() / np.abs(one[k]).max()), k)
                    for k in moments if np.abs(one[k]).max() > 1e-3 * top)
        print(f"mesh {shape[0]} x {shape[1]}: metrics rel "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f"; worst first moment {worst[0]:.3g} of its largest ({worst[1]})")


if __name__ == "__main__":
    main()
