"""sivae_torch eval / CBIR path against the JAX package on the same inputs:
synthetic data (bit-identical), preprocessing, metrics (per volume and
batched), retrieval, batch encoding, the reconstruction report and the
checkpoint sweep on `tiny_spatial`, each also on a model left in training
mode; the latent embedding and its scatter; the eval CLI; the rule that the
port imports nothing of JAX; and the rule that entry points refuse to run
on the CPU unasked."""

import ast
import copy
import functools
import json
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
from sivae_tpu.eval.latent_probe import latent_embedding as jax_latent_embedding
from sivae_tpu.eval.recon_quality import make_rec_fn as jax_make_rec_fn
from sivae_tpu.eval.recon_quality import reconstruction_report as jax_reconstruction_report
from sivae_tpu.eval.retrieval import cosine_knn as jax_cosine_knn
from sivae_tpu.eval.retrieval import retrieval_precision_at_k as jax_retrieval_precision_at_k
from sivae_tpu.ops import metrics as jax_metrics
from sivae_torch.data.pipeline import grouped_split
from sivae_torch.data.preprocess import preprocess_batch, preprocess_voxel_np
from sivae_torch.data.synthetic import SyntheticBrainSource, synthetic_brain_batch
from sivae_torch.eval.latent_probe import (encode_dataset, latent_2d_embedding, latent_embedding,
                                           save_embedding_scatter)
from sivae_torch.eval.recon_quality import reconstruct, reconstruction_report
from sivae_torch.eval.retrieval import cosine_knn, retrieval_precision_at_k
from sivae_torch.eval.sweep import sweep_checkpoints
from sivae_torch.ops import metrics
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import CheckpointManager
from torch_port_common import assert_close_scaled, load_tool, tiny_pair

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


# The volumes of the encode / report cases (NDHWC, as JAX takes them), and
# JAX's results on them, computed once per module: each JAX call compiles.
ENCODE_VOX = np.random.RandomState(6).rand(5, 16, 16, 16, 1).astype(np.float32)  # tail of 1
REPORT_VOX = np.random.RandomState(7).rand(3, 16, 16, 16, 1).astype(np.float32)
RECON_KEYS = ("rmse", "psnr", "ssim3d", "ssim_center_slice")


def _ncdhw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


@pytest.fixture(scope="module")
def jax_result(pair):
    """JAX's result on the module's volumes by name, each computed on first
    use and kept: every JAX call compiles."""
    model_j, variables, _ = pair

    @functools.lru_cache(maxsize=None)
    def get(what):
        if what in ("mu", "z_val"):
            return jax_encode_dataset(model_j, variables, ENCODE_VOX, batch_size=2,
                                      representation=what)
        if what == "report":
            return jax_reconstruction_report(model_j, variables, REPORT_VOX, batch_size=2)
        assert what == "reconstruct"
        y = jax_make_rec_fn(model_j)(variables, REPORT_VOX[:2])
        return np.asarray(y, np.float32).transpose(0, 4, 1, 2, 3)

    return get


def _assert_encode_matches(got, want):
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))


def _assert_report_matches(got, want):
    assert got["n"] == want["n"] == 3
    for k in RECON_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("representation", ["mu", "z_val"])
def test_encode_dataset_matches_jax(pair, jax_result, representation):
    got = encode_dataset(pair[2], _ncdhw(ENCODE_VOX), batch_size=2, representation=representation)
    _assert_encode_matches(got, jax_result(representation))


def test_reconstruction_report_matches_jax(pair, jax_result):
    got = reconstruction_report(pair[2], _ncdhw(REPORT_VOX), batch_size=2)
    _assert_report_matches(got, jax_result("report"))


def _run_eval_function(name, model, tmp_path):
    """One of the four eval-mode functions on `model`, and its result in a
    form JAX's result is held to."""
    if name == "encode_dataset":
        return encode_dataset(model, _ncdhw(ENCODE_VOX), batch_size=2)
    if name == "reconstruct":
        return reconstruct(model, _ncdhw(REPORT_VOX[:2])).numpy()
    if name == "reconstruction_report":
        return reconstruction_report(model, _ncdhw(REPORT_VOX), batch_size=2)
    # the sweep over one checkpoint of the model's own weights and statistics
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, create_train_state(model))
    (row,) = sweep_checkpoints(model, _ncdhw(REPORT_VOX), ckpt_dir=mgr.directory, batch_size=2)
    assert row.pop("checkpoint") == "0"
    return row


@pytest.mark.parametrize("name", ["encode_dataset", "reconstruct", "reconstruction_report",
                                  "sweep_checkpoints"])
def test_eval_functions_run_in_eval_mode(pair, jax_result, name, tmp_path):
    """Called on a model in training mode (dropout on), each function gives
    the eval-mode result (the eval-mode call's exactly, and JAX's, which runs
    with train=False, within the tolerances above), leaves every buffer
    (running statistics, `num_batches_tracked`) unchanged bit for bit and
    leaves the model in training mode."""
    model = copy.deepcopy(pair[2]).train()
    assert any(getattr(m, "rate", 0.0) > 0 for m in model.modules())  # dropout is on
    before = {k: v.clone() for k, v in model.named_buffers()}
    got = _run_eval_function(name, model, tmp_path)
    assert model.training and all(m.training for m in model.modules())
    after = dict(model.named_buffers())
    assert set(after) == set(before) and any("num_batches_tracked" in k for k in before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    want_eval = _run_eval_function(name, model.eval(), tmp_path / "eval")
    if name == "encode_dataset":
        np.testing.assert_array_equal(got, want_eval)
        _assert_encode_matches(got, jax_result("mu"))
    elif name == "reconstruct":
        np.testing.assert_array_equal(got, want_eval)
        assert_close_scaled(got, jax_result("reconstruct"), 1e-4)
    else:
        assert got == want_eval
        _assert_report_matches(got, jax_result("report"))


@pytest.mark.parametrize("shape", [(12, 14, 11), (9, 20, 16)])
def test_batched_metrics_match_jax(shape):
    """`batch_rmse` / `batch_psnr` / `batch_ssim` of each volume of a batch
    against JAX's per-volume metrics, and `batch_ssim_center_slice` (NCDHW)
    against JAX's (NDHWC), within 1e-5; the batched forms also against the
    port's per-volume ones."""
    rng = np.random.RandomState(8)
    x = rng.rand(3, 1, *shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(*x.shape), 0, 1).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for name in ("rmse", "psnr", "ssim"):
        got = getattr(metrics, "batch_" + name)(xt[:, 0], yt[:, 0]).numpy()
        want = [float(getattr(jax_metrics, name)(jnp.asarray(x[i, 0]), jnp.asarray(y[i, 0])))
                for i in range(3)]
        own = [float(getattr(metrics, name)(xt[i, 0], yt[i, 0])) for i in range(3)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got, own, rtol=1e-6, atol=1e-6, err_msg=name)
    got = metrics.batch_ssim_center_slice(xt, yt)
    want = jax_metrics.batch_ssim_center_slice(x.transpose(0, 2, 3, 4, 1),
                                               y.transpose(0, 2, 3, 4, 1))
    assert isinstance(got, np.ndarray) and got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(metrics.batch_ssim_center_slice(x[:, 0], y[:, 0]), got, atol=0)


def test_report_and_sweep_write_their_panels(pair, jax_result, tmp_path):
    """`reconstruction_report(panel_path=...)` writes the first batch's
    panel and returns JAX's keys; `sweep_checkpoints(panel_dir=...)` writes
    `recon_<tag>.jpg` per checkpoint."""
    model = pair[2]
    panel = tmp_path / "panels" / "recon.jpg"
    rep = reconstruction_report(model, _ncdhw(REPORT_VOX), batch_size=2, panel_path=str(panel))
    assert panel.stat().st_size > 0
    assert set(rep) == set(jax_result("report"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in (0, 1):
        mgr.save(step, create_train_state(copy.deepcopy(model)))
    rows = sweep_checkpoints(copy.deepcopy(model), _ncdhw(REPORT_VOX[:1]), ckpt_dir=mgr.directory,
                             batch_size=2, panel_dir=str(tmp_path / "sweep"))
    assert [r["checkpoint"] for r in rows] == ["0", "1"]
    assert sorted(os.listdir(tmp_path / "sweep")) == ["recon_0.jpg", "recon_1.jpg"]


@pytest.mark.parametrize("dim,pca_dim", [(2, 8), (2, 0), (3, 8), (3, 0)])
def test_latent_embedding_matches_jax(dim, pca_dim):
    """PCA (on when pca_dim < the latent width and the point count) then
    t-SNE, the port's against JAX's on the same 40 latents and seed: both
    call scikit-learn, so within 1e-6."""
    z = np.random.RandomState(9).randn(40, 16).astype(np.float32)
    got, used = latent_embedding(z, n_components=dim, pca_dim=pca_dim, seed=3,
                                 return_method=True)
    want = jax_latent_embedding(z, n_components=dim, pca_dim=pca_dim, seed=3)
    assert used == "tsne" and got.shape == (40, dim)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if dim == 2 and pca_dim == 0:
        np.testing.assert_allclose(latent_2d_embedding(z, pca_dim=0, seed=3), want, atol=1e-6)


def test_umap_falls_back_to_tsne_with_a_warning(monkeypatch):
    monkeypatch.setitem(sys.modules, "umap", None)  # umap does not import
    z = np.random.RandomState(9).randn(40, 16).astype(np.float32)
    with pytest.warns(UserWarning, match="umap"):
        emb, used = latent_embedding(z, method="umap", pca_dim=0, seed=3, return_method=True)
    assert used == "tsne"
    np.testing.assert_array_equal(emb, latent_embedding(z, method="tsne", pca_dim=0, seed=3))


@pytest.mark.parametrize("dim", [2, 3])
def test_save_embedding_scatter_writes_png(tmp_path, dim):
    rng = np.random.RandomState(dim)
    path = tmp_path / "maps" / f"latent_tsne_{dim}d.png"
    save_embedding_scatter(rng.randn(20, dim), rng.randint(0, 2, 20), str(path),
                           class_names=["CN", "AD"], title=f"t-SNE {dim}D")
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


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
    report = json.loads(out.read_text())
    assert REPORT_KEYS <= set(report)
    assert report["n"] > 0 and all(np.isfinite(v) for v in report.values())


# the keys the JAX eval CLI adds for `--embed` (cli/eval.py:118-137)
EMBED_KEYS = {"embed_points", "tsne_points", "embed_method"}


def test_eval_cli_embedding_and_panels(tmp_path):
    """`--embed tsne --embed-dim 3 --out`: the JAX CLI's report keys, the
    recon panel and the 3D latent map under `<out>_panels/`."""
    from sivae_torch.cli.eval import main

    out = tmp_path / "report.json"
    report = main(["--model", "tiny_spatial", "--synthetic", "16", "--device", "cpu",
                   "--embed", "tsne", "--embed-dim", "3", "--out", str(out)])
    assert REPORT_KEYS | EMBED_KEYS <= set(report) and json.loads(out.read_text()) == report
    assert report["embed_method"] == "tsne"
    assert report["embed_points"] == report["tsne_points"] > 2
    panels = tmp_path / "report.json_panels"
    assert sorted(os.listdir(panels)) == ["latent_tsne_3d.png", "recon.jpg"]


def test_eval_cli_refuses_embed_without_sklearn(monkeypatch, capsys):
    """Where scikit-learn does not import, `--tsne` / `--embed` exit 2 before
    any work (no device is asked for: this would raise without CUDA)."""
    from sivae_torch.cli.eval import main

    monkeypatch.setitem(sys.modules, "sklearn", None)
    for flags in (["--tsne"], ["--embed", "umap"]):
        with pytest.raises(SystemExit) as ei:
            main(["--model", "tiny_spatial", "--synthetic", "4"] + flags)
        assert ei.value.code == 2 and "scikit-learn" in capsys.readouterr().err


def test_eval_cli_skips_panels_without_matplotlib(monkeypatch, tmp_path, capsys):
    from sivae_torch.cli.eval import main

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    report = main(["--model", "tiny_spatial", "--synthetic", "12", "--device", "cpu",
                   "--out", str(tmp_path / "r.json")])
    skipped = [line for line in capsys.readouterr().out.splitlines() if "skipped" in line]
    assert len(skipped) == 1 and "matplotlib" in skipped[0]
    assert set(report) >= REPORT_KEYS and not (tmp_path / "r.json_panels").exists()


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
    for tool in ("torch_posthoc_health", "torch_sweep_run"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_tool(tool).main([str(ROOT / "runs" / "absent")])


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
        ROOT / "tools" / "torch_conv_blocks.py", ROOT / "tools" / "torch_posthoc_health.py",
        ROOT / "tools" / "torch_sweep_run.py"]
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
        "for name in ('train.step', 'train.state', 'ops.losses', 'kernels.conv3d_fused',\n"
        "             'eval.run_dir', 'data.dict_dataset', 'parallel.mesh',\n"
        "             'parallel.distributed'):\n"
        "    assert 'sivae_torch.' + name in names, name\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
