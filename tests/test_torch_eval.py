"""sivae_torch eval / CBIR path against the JAX package on the same inputs:
synthetic data (bit-identical), preprocessing, metrics, retrieval, batch
encoding and the reconstruction report on `tiny_spatial`; the eval CLI; the
rule that the port imports nothing of JAX; and the rule that entry points
refuse to run on the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.data.pipeline import grouped_split as jax_grouped_split
from sivae_tpu.data.preprocess import preprocess_batch as jax_preprocess_batch
from sivae_tpu.data.synthetic import SyntheticBrainSource as JaxSyntheticBrainSource
from sivae_tpu.data.synthetic import synthetic_brain_batch as jax_synthetic_brain_batch
from sivae_tpu.eval.latent_probe import encode_dataset as jax_encode_dataset
from sivae_tpu.eval.recon_quality import reconstruction_report as jax_reconstruction_report
from sivae_tpu.eval.retrieval import cosine_knn as jax_cosine_knn
from sivae_tpu.eval.retrieval import retrieval_precision_at_k as jax_retrieval_precision_at_k
from sivae_tpu.ops import metrics as jax_metrics
from sivae_torch.data.pipeline import grouped_split
from sivae_torch.data.preprocess import preprocess_batch, preprocess_voxel_np
from sivae_torch.data.synthetic import SyntheticBrainSource, synthetic_brain_batch
from sivae_torch.eval.latent_probe import encode_dataset
from sivae_torch.eval.recon_quality import reconstruction_report
from sivae_torch.eval.retrieval import cosine_knn, retrieval_precision_at_k
from sivae_torch.ops import metrics
from torch_port_common import tiny_pair

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REPORT_KEYS = {"retrieval_p_at_k", "rmse", "psnr", "ssim3d", "ssim_center_slice", "n"}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


def test_synthetic_volumes_bit_identical():
    v_t, l_t = synthetic_brain_batch(3, (12, 16, 12), seed=7)
    v_j, l_j = jax_synthetic_brain_batch(3, (12, 16, 12), seed=7)
    assert np.array_equal(v_t, v_j) and np.array_equal(l_t, l_j)
    rt = list(SyntheticBrainSource(4, (8, 8, 8), seed=5))
    rj = list(JaxSyntheticBrainSource(4, (8, 8, 8), seed=5))
    for a, b in zip(rt, rj):
        assert {k: v for k, v in a.items() if k != "voxel"} == \
               {k: v for k, v in b.items() if k != "voxel"}
        assert np.array_equal(a["voxel"], b["voxel"])


@pytest.mark.parametrize("n,n_groups,n_classes,seed", [
    (32, 16, 2, 103), (40, 23, 3, 0), (57, 57, 4, 7)])
def test_grouped_split_matches_jax(n, n_groups, n_classes, seed):
    """The port's split gives the JAX package's indices."""
    rng = np.random.RandomState(n)
    labels = rng.randint(0, n_classes, n)
    pids = [f"p{g:03d}" for g in rng.randint(0, n_groups, n)]
    for fold in range(5):
        got = grouped_split(labels, pids, 5, fold, seed)
        want = jax_grouped_split(labels, pids, 5, fold, seed)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_preprocess_matches_jax():
    vox, _ = synthetic_brain_batch(3, (10, 12, 10), seed=2)
    got = preprocess_batch(torch.from_numpy(vox)).numpy()
    want = np.asarray(jax_preprocess_batch(jnp.asarray(vox)))
    assert got.shape == (3, 1, 10, 12, 10)
    np.testing.assert_allclose(got[:, 0], want[..., 0], atol=1e-6)
    np.testing.assert_allclose(got[1, 0], preprocess_voxel_np(vox[1]), atol=1e-6)


@pytest.mark.parametrize("shape", [(12, 14, 11), (20, 16)])
def test_metrics_match_jax(shape):
    rng = np.random.RandomState(4)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("rmse", "psnr", "ssim"):
        got = float(getattr(metrics, name)(at, bt))
        want = float(getattr(jax_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_retrieval_matches_jax():
    rng = np.random.RandomState(5)
    q, db = rng.randn(7, 30).astype(np.float32), rng.randn(20, 30).astype(np.float32)
    ql, dl = rng.randint(0, 2, 7), rng.randint(0, 2, 20)
    s_t, i_t = cosine_knn(torch.from_numpy(q), torch.from_numpy(db), k=5)
    s_j, i_j = jax_cosine_knn(jnp.asarray(q), jnp.asarray(db), k=5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    for k, excl in ((5, False), (3, True), (50, False)):
        assert retrieval_precision_at_k(q, ql, db, dl, k=k, exclude_self=excl) == \
            jax_retrieval_precision_at_k(q, ql, db, dl, k=k, exclude_self=excl)


@pytest.mark.parametrize("representation", ["mu", "z_val"])
def test_encode_dataset_matches_jax(pair, representation):
    model_j, variables, model_t = pair
    vox = np.random.RandomState(6).rand(5, 16, 16, 16, 1).astype(np.float32)  # tail of 1
    want = jax_encode_dataset(model_j, variables, vox, batch_size=2,
                              representation=representation)
    got = encode_dataset(model_t, torch.from_numpy(vox).permute(0, 4, 1, 2, 3), batch_size=2,
                         representation=representation)
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_reconstruction_report_matches_jax(pair):
    model_j, variables, model_t = pair
    vox = np.random.RandomState(7).rand(3, 16, 16, 16, 1).astype(np.float32)
    want = jax_reconstruction_report(model_j, variables, vox, batch_size=2)
    got = reconstruction_report(model_t, torch.from_numpy(vox).permute(0, 4, 1, 2, 3),
                                batch_size=2)
    assert got["n"] == want["n"] == 3
    for k in ("rmse", "psnr", "ssim3d", "ssim_center_slice"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_eval_cli_prints_report_keys(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run([sys.executable, "-m", "sivae_torch.cli.eval", "--model", "tiny_spatial",
                           "--synthetic", "12", "--device", "cpu", "--out", str(out)],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json

    report = json.loads(out.read_text())
    assert REPORT_KEYS <= set(report)
    assert report["n"] > 0 and all(np.isfinite(v) for v in report.values())


def test_entry_points_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from sivae_torch.cli.eval import main
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(get_model_config("tiny_spatial"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "tiny_spatial", "--synthetic", "4"])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "sivae_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_sass_report.py",
        ROOT / "tools" / "torch_conv_blocks.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "sivae_tpu")]
    assert bad == []


def test_port_package_imports_without_jax_installed():
    """Import every port module in a process where `jax`, `flax` and
    `sivae_tpu` cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sivae_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sivae_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sivae_torch.__path__, 'sivae_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('train.step', 'train.state', 'ops.losses', 'kernels.conv3d_fused'):\n"
        "    assert 'sivae_torch.' + name in names, name\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
