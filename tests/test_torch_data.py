"""sivae_torch data layer against the JAX package on the same inputs: the
catalog walk, the dict-sample `BrainData` view, the prefetching pipeline
(order, batches, drop-last, augmentation seeding, thread teardown) and the
on-device augmentation.

Tolerances: batches after preprocessing 1e-6 (both normalise in fp32; the
port takes the standard deviation in fp64 and rounds it once, JAX sums in
fp32); the affine resample 1e-5 (fp32 source coordinates, computed in
another order, times value steps of O(1) per voxel).
"""

import gc
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from sivae_tpu.data.augment import _affine_resample as jax_affine_resample
from sivae_tpu.data.augment import _rotation_matrix as jax_rotation_matrix
from sivae_tpu.data.catalog import load_data as jax_load_data
from sivae_tpu.data.dict_dataset import BrainData as JaxBrainData
from sivae_tpu.data.pipeline import BrainDataSource as JaxBrainDataSource
from sivae_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from sivae_torch.data.augment import (_affine_resample, _rotation_matrix, random_affine_batch,
                                      random_noise_batch)
from sivae_torch.data.catalog import CLASS_MAP, load_data
from sivae_torch.data.dict_dataset import BrainData
from sivae_torch.data.preprocess import preprocess_batch
from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
from sivae_torch.data.synthetic import SyntheticBrainSource, synthetic_brain_batch

torch.set_num_threads(2)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------


@pytest.fixture()
def fake_adni_tree(tmp_path):
    """The ADNI2-layout tree of tests/test_cli_e2e.py: 2 classes x 6 patients
    of 16^3 volumes, the last AD uid blacklisted, plus a second scan of one
    CN patient for the `unique` filter."""
    root = tmp_path / "radiology_datas"
    base = root / "JHU-radiology" / "20170509"
    uid = 100
    rng = np.random.RandomState(0)
    for label in ("CN", "AD"):
        for p in range(6):
            uid += 1
            d = base / label / f"{label.lower()}{p:02d}"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / f"scan_half_brain_S{uid}_1.pkl", "wb") as f:
                pickle.dump(rng.rand(16, 16, 16).astype(np.float32), f)
    with open(base / "CN" / "cn00" / "scan_half_brain_S150_2.pkl", "wb") as f:
        pickle.dump(rng.rand(16, 16, 16).astype(np.float32), f)
    bl = root / "util" / "lists" / "x"
    bl.mkdir(parents=True)
    (bl / "uids.txt").write_text(f"{uid}\n")
    return root


CATALOG_CASES = {
    "all": dict(),
    "blacklist": dict(blacklist=True),
    "unique": dict(unique=True),
    "uids": dict(uids=[103, 150]),
    "pids": dict(classes=["CN"], pids=["cn00"]),
}


@pytest.mark.parametrize("case", sorted(CATALOG_CASES))
def test_catalog_records_match_jax(fake_adni_tree, case):
    kw = dict(kinds=["ADNI2"], classes=["CN", "AD"], root=fake_adni_tree)
    kw.update(CATALOG_CASES[case])
    got, want = load_data(**kw), jax_load_data(**kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) >= {"uid", "pid", "label", "nu_label", "path", "voxel"}
        assert (g["uid"], g["pid"], g["label"], g["nu_label"], g["path"]) == \
            (w["uid"], w["pid"], w["label"], w["nu_label"], w["path"])
        assert g["nu_label"] == CLASS_MAP[g["label"]]
        np.testing.assert_array_equal(g["voxel"], w["voxel"])
    if case == "blacklist":
        assert len(got) == 12 and 112 not in {r["uid"] for r in got}


# ---------------------------------------------------------------------------
# BrainData
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "catalog"])
def test_brain_data_matches_jax(fake_adni_tree, source):
    """The port's dict samples against JAX's on the same records: the voxel
    channel-first (1, D, H, W) where JAX's is channel-last (D, H, W, 1), the
    same bits; labels, uid, pid; the transform applied lazily (the documented
    deviation from the reference's no-op); slices, iteration, `labels()` and
    `as_arrays()` (N, 1, D, H, W), whose volumes `preprocess_batch` takes."""
    if source == "synthetic":
        records = SyntheticBrainSource(5, (6, 8, 7), seed=3).records
    else:
        records = load_data(kinds=["ADNI2"], classes=["CN", "AD"], root=fake_adni_tree)
    calls = []

    def double(v):
        calls.append(v.shape)
        return v * 2.0

    for transform in (None, double):
        got, want = BrainData(records, transform), JaxBrainData(records, transform)
        assert len(got) == len(want) == len(records) and not calls
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"voxel", "label", "uid", "pid"}
            assert {k: g[k] for k in ("label", "uid", "pid")} == \
                {k: w[k] for k in ("label", "uid", "pid")}
            assert g["voxel"].dtype == np.float32 and g["voxel"].shape[0] == 1
            np.testing.assert_array_equal(g["voxel"], np.moveaxis(w["voxel"], -1, 0))
        assert [s["uid"] for s in got[1:4]] == [s["uid"] for s in want[1:4]]
        np.testing.assert_array_equal(got.labels(), want.labels())
        np.testing.assert_array_equal(got.labels(), [CLASS_MAP[r["label"]] for r in records])
        vox, labels = got.as_arrays()
        jvox, jlabels = want.as_arrays()
        assert vox.shape == (len(records), 1) + jvox.shape[1:4]
        np.testing.assert_array_equal(vox, jvox.transpose(0, 4, 1, 2, 3))
        np.testing.assert_array_equal(labels, jlabels)
        x = preprocess_batch(torch.from_numpy(vox[:, 0]))
        assert x.shape == vox.shape and float(x.min()) >= 0.0 and float(x.max()) <= 1.0 + 1e-6
    assert calls and all(c == records[0]["voxel"].shape for c in calls)
    np.testing.assert_array_equal(BrainData(records, double)[0]["voxel"],
                                  2.0 * BrainData(records)[0]["voxel"])


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _sources(n=10, shape=(16, 16, 16), seed=5):
    records = SyntheticBrainSource(n, shape=shape, seed=seed).records
    return BrainDataSource(records), JaxBrainDataSource(records)


def test_pipeline_order_and_batches_match_jax():
    """Epochs 0 and 1: the same shuffled order (labels and volumes), the
    same preprocessed values in the port's NCDHW layout, the trailing
    partial batch dropped (10 volumes, batch 4: 2 steps)."""
    src_t, src_j = _sources()
    port = DataPipeline(src_t, batch_size=4, device="cpu", seed=7)
    ref = JaxDataPipeline(src_j, batch_size=4, seed=7)
    assert port.steps_per_epoch == ref.steps_per_epoch == 2
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 2
        for (vox, lab), (vox_j, lab_j) in zip(got, want):
            np.testing.assert_array_equal(lab, np.asarray(lab_j))
            assert vox.shape == (4, 1, 16, 16, 16) and vox.dtype == torch.float32
            np.testing.assert_allclose(vox[:, 0].numpy(), np.asarray(vox_j)[..., 0], atol=1e-6)
    assert not torch.equal(got[0][0], list(port.epoch(0))[0][0])  # epoch 1's order differs


def test_pipeline_augmentation_is_deterministic_per_seed_epoch_step():
    src, _ = _sources(n=8, shape=(12, 12, 12))
    aug = lambda gen, vox: random_affine_batch(gen, vox, degrees=15.0, p=1.0)  # noqa: E731
    plain = DataPipeline(src, batch_size=4, device="cpu", shuffle=False, seed=1)
    auged = DataPipeline(src, batch_size=4, device="cpu", shuffle=False, seed=1, augment=aug)
    p0 = [v for v, _ in plain.epoch(0)]
    a0, a0_again, a1 = ([v for v, _ in auged.epoch(e)] for e in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a0, a0_again))
    assert not torch.allclose(p0[0], a0[0])
    assert not torch.allclose(a0[0], a1[0])   # another epoch, other draws
    # another pipeline seed, other draws
    other_seed = DataPipeline(src, batch_size=4, device="cpu", shuffle=False, seed=2,
                              augment=aug)
    assert not torch.allclose(a0[0], next(other_seed.epoch(0))[0])
    assert all(float(v.min()) >= 0.0 and float(v.max()) <= 1.0 for v in a0)


def test_pipeline_abandoned_epochs_leak_no_threads():
    """Abandoning the epoch generator (closed, or dropped without close)
    must not leave producer threads behind (tests/test_data.py:164-191)."""
    src = BrainDataSource(SyntheticBrainSource(16, shape=(8, 8, 8), seed=3).records)
    pipe = DataPipeline(src, batch_size=2, device="cpu", shuffle=False, seed=1)
    assert pipe.steps_per_epoch == 8
    pipe.first_batch()
    gc.collect()
    before = threading.active_count()
    for _ in range(100):
        gen = pipe.epoch(0)
        next(gen)
        gen.close()
    for _ in range(20):
        gen = pipe.epoch(0)
        next(gen)
        del gen
    gc.collect()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_pipeline_refuses_fewer_volumes_than_a_batch():
    src, _ = _sources(n=3)
    with pytest.raises(ValueError):
        DataPipeline(src, batch_size=4, device="cpu")


def test_pipeline_surfaces_producer_errors():
    src, _ = _sources(n=4)

    def broken(gen, vox):
        raise RuntimeError("augment failed")

    with pytest.raises(RuntimeError, match="augment failed"):
        list(DataPipeline(src, batch_size=2, device="cpu", augment=broken).epoch(0))


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def _golden_volume():
    """tests/test_data.py's structured volume: a ramp plus an off-centre box."""
    rng = np.random.RandomState(3)
    d, h, w = 13, 17, 11
    vol = np.fromfunction(lambda z, y, x: 0.1 * z + 0.05 * y + 0.02 * x, (d, h, w),
                          dtype=np.float32).astype(np.float32)
    vol[3:6, 9:14, 2:5] += 1.0
    vol += 0.05 * rng.rand(d, h, w).astype(np.float32)
    return vol


RESAMPLE_CASES = [  # tests/test_data.py:284-289
    dict(angles=(10.0, -20.0, 5.0), scales=(1.0, 1.0, 1.0), t=(0, 0, 0)),
    dict(angles=(0.0, 0.0, 0.0), scales=(1.1, 0.9, 1.05), t=(0, 0, 0)),
    dict(angles=(-15.0, 7.0, 30.0), scales=(0.95, 1.08, 1.0), t=(0, 0, 0)),
    dict(angles=(8.0, 0.0, -12.0), scales=(1.0, 1.02, 0.97), t=(1.5, -2.0, 0.5)),
]


@pytest.mark.parametrize("case", range(len(RESAMPLE_CASES)))
def test_affine_resample_matches_jax_and_scipy(case):
    """The trilinear resample through the inverse affine, about the volume
    centre, zero fill: against JAX's `_affine_resample` and against
    scipy.ndimage.affine_transform (order 1, "grid-constant")."""
    c = RESAMPLE_CASES[case]
    vol = _golden_volume()
    d, h, w = vol.shape
    center = np.array([(d - 1) / 2, (h - 1) / 2, (w - 1) / 2])
    ang = np.deg2rad(np.array(c["angles"], np.float32))
    rot = _rotation_matrix(torch.from_numpy(ang)).numpy()
    np.testing.assert_allclose(rot, np.asarray(jax_rotation_matrix(jnp.asarray(ang))), atol=1e-7)
    inv = (rot.T * (1.0 / np.array(c["scales"]))[None, :]).astype(np.float32)
    t = np.array(c["t"], np.float32)
    got = _affine_resample(torch.from_numpy(vol)[None], torch.from_numpy(inv),
                           torch.from_numpy(t) if t.any() else None)[0].numpy()
    want_j = np.asarray(jax_affine_resample(jnp.asarray(vol), jnp.asarray(inv),
                                            jnp.asarray(t) if t.any() else None))
    want_s = scipy.ndimage.affine_transform(vol, inv, offset=center - inv @ (center + t), order=1,
                                            mode="grid-constant", cval=0.0, prefilter=False)
    np.testing.assert_allclose(got, want_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_s, rtol=0, atol=1e-5)


def test_random_affine_batch_draws_per_volume():
    vox, _ = synthetic_brain_batch(3, (12, 12, 12), seed=2)
    x = torch.from_numpy(vox)
    np.testing.assert_array_equal(random_affine_batch(_gen(), x, p=0.0).numpy(), vox)
    out = random_affine_batch(_gen(), x, degrees=15.0, p=1.0)
    assert out.shape == x.shape and not torch.allclose(out, x)
    # mass approximately preserved (rotation of a centred blob, zero fill)
    assert abs(float(out.sum() - x.sum())) / float(x.sum()) < 0.15
    # the channel axis is kept, and the same draws give the same volumes
    out5 = random_affine_batch(_gen(), x[:, None], degrees=15.0, p=1.0)
    assert out5.shape == (3, 1, 12, 12, 12) and torch.equal(out5[:, 0], out)
    assert not torch.equal(out[0], out[1])
    assert not torch.equal(out, random_affine_batch(_gen(1), x, degrees=15.0, p=1.0))


def test_random_noise_batch():
    """tests/test_data.py:138-144: mean 1, std 0.01, p 1 -> mean ~1; p 0 is
    the identity."""
    vox = torch.zeros((4, 6, 6, 6))
    out = random_noise_batch(_gen(), vox, mean=1.0, std=0.01, p=1.0)
    assert abs(float(out.mean()) - 1.0) < 0.01
    assert abs(float(out.std()) - 0.01) < 0.002
    assert torch.equal(random_noise_batch(_gen(), vox, p=0.0), vox)
