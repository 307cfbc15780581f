"""Dataset catalog: walk the radiology pickle tree into records.

The port's own copy of `sivae_tpu/data/catalog.py` (which the port may not
import): the reference catalog (datasets/dataset.py: DATA_DIRS_DICT :26-32,
CLASS_MAP :39-54, get_uid :74-106, get_blacklist :127-143, load_csv_data
:146-165, load_data :168-287) with the same record schema
{uid, pid, label, nu_label, path, voxel[, AGE, SEX]}, a configurable root
and no eager per-record pandas scans. Voxels stay numpy arrays on the host;
the pipeline moves them to the device.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_ROOT = pathlib.Path("/data") / "radiology_datas"

# 13 diagnosis labels (reference datasets/dataset.py:39-54)
CLASS_MAP: Dict[str, int] = {
    "CN": 0, "AD": 1, "EMCI": 2, "LMCI": 3, "MCI": 4, "SMC": 5,
    "Control": 6, "FControl": 6, "PD": 7, "SWEDD": 8, "Prodromal": 9,
    "CBD": 10, "PSP": 11, "Oth": 12,
}

SIZE_PREFIX = {"fullsize": "fullsize", "half": "half_"}


def data_dirs(root: pathlib.Path) -> Dict[str, pathlib.Path]:
    """Per-collection subtrees (reference datasets/dataset.py:12-16, 26-32)."""
    return {
        "ADNI1": root / "ADNI1",
        "ADNI2": root / "JHU-radiology" / "20170509",
        "ADNI2-2": root / "JHU-radiology" / "MNI_skull_stripped" / "output",
        "PPMI": root / "JHU-radiology" / "PPMI",
        "4RTNI": root / "JHU-radiology" / "4RTNI" / "SkullStripped",
    }


def csv_paths(root: pathlib.Path) -> Dict[str, pathlib.Path]:
    return {
        "ADNI": root / "JHU-radiology" / "ADNIMERGE.csv",
        "PPMI": root / "JHU-radiology" / "PPMI.csv",
        "4RTNI": root / "JHU-radiology" / "4RTNI" / "csv" / "4RTNI_DATA.csv",
    }


def read_voxel(path) -> np.ndarray:
    """Load one volume as float32.

    Pickled arrays (the reference's format, read_voxel :57-71) and NIfTI
    (.nii / .nii.gz, via nibabel when installed) are supported.
    """
    name = str(path)
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        try:
            import nibabel as nib
        except ImportError as e:
            raise ImportError(
                "NIfTI volumes need nibabel (pip install nibabel)") from e
        return np.asarray(nib.load(name).get_fdata(), dtype=np.float32)
    with open(path, "rb") as rf:
        voxel = pickle.load(rf)
    return np.asarray(voxel, dtype=np.float32)


def get_uid(path: pathlib.Path, dirs: Dict[str, pathlib.Path]):
    """Per-collection uid parsing from the filename (reference get_uid :74-106)."""
    for key, value in dirs.items():
        if str(value) in str(path):
            parts = path.name.split("_")
            if key == "ADNI2":
                return int(parts[-2][1:])
            if key == "ADNI2-2":
                return int(parts[-4][1:])
            if key in ("PPMI", "4RTNI"):
                return int(parts[-4])
            return path.name
    return path.name


def get_blacklist(root: pathlib.Path) -> List[int]:
    """uids listed in util/lists/**/uids.txt (reference get_blacklist :127-143)."""
    excluded: List[int] = []
    for p in (root / "util" / "lists").glob("**/uids.txt"):
        with open(p) as rf:
            excluded.extend(int(line.rstrip("\n")) for line in rf if line.strip())
    return excluded


def load_csv_data(root: pathlib.Path):
    """AGE/SEX join table from the ADNI/PPMI/4RTNI csvs (reference :146-165)."""
    import pandas as pd

    frames = []
    paths = csv_paths(root)
    spec = {
        "ADNI": ("PTID", "AGE", "PTGENDER"),
        "PPMI": ("Subject", "Age", "Sex"),
        "4RTNI": ("SUBID", "AGE_AT_TP0", "SEX"),
    }
    for key, (pid_c, age_c, sex_c) in spec.items():
        if not paths[key].exists():
            continue
        df = pd.read_csv(paths[key])[[pid_c, age_c, sex_c]]
        df.columns = ["PID", "AGE", "SEX"]
        frames.append(df)
    if not frames:
        return None
    df = pd.concat(frames, ignore_index=True)
    df["SEX"] = df["SEX"].apply(lambda x: x[0] if x in ("Male", "Female") else x)
    df["AGE"] = df["AGE"].apply(int)
    df["PID"] = df["PID"].apply(str)
    return df


def load_data(
    kinds: Sequence[str] = ("ADNI2", "ADNI2-2", "PPMI", "4RTNI"),
    classes: Sequence[str] = tuple(CLASS_MAP),
    size: str = "half",
    csv: bool = False,
    pids: Sequence[str] = (),
    uids: Sequence[int] = (),
    unique: bool = False,
    blacklist: bool = False,
    dryrun: bool = False,
    root: Optional[pathlib.Path] = None,
    load_voxels: bool = True,
) -> List[dict]:
    """Build the record list (reference load_data :168-287).

    dryrun=True (or load_voxels=False) skips reading voxel payloads.
    Returns a plain list of dicts rather than a numpy object array.
    """
    root = pathlib.Path(root) if root is not None else DEFAULT_ROOT
    dirs = data_dirs(root)
    class_dirs = []
    for key in kinds:
        for c in classes:
            d = dirs[key].resolve() / c
            if d.exists():
                class_dirs.append(d)

    pattern = "**/*" + SIZE_PREFIX[size] + "*.pkl"
    dataset: List[dict] = []
    for dir_path in class_dirs:
        for file_path in sorted(dir_path.glob(pattern)):
            dataset.append({
                "uid": get_uid(file_path, dirs),
                "pid": file_path.parent.name,
                "label": dir_path.name,
                "nu_label": CLASS_MAP[dir_path.name],
                "path": file_path,
            })

    if uids:
        want = set(uids)
        dataset = [d for d in dataset if d["uid"] in want]

    if unique:
        # keep only the newest scan (max uid) per patient (reference :251-261)
        by_pid: Dict[str, List[dict]] = {}
        for d in dataset:
            by_pid.setdefault(d["pid"], []).append(d)
        dataset = [sorted(v, key=lambda d: d["uid"])[-1] for v in by_pid.values()]

    if pids:
        want = set(pids)
        dataset = [d for d in dataset if d["pid"] in want]

    if blacklist:
        excluded = set(get_blacklist(root))
        dataset = [d for d in dataset if d["uid"] not in excluded]

    if dryrun:
        return dataset

    if csv:
        df = load_csv_data(root)
        if df is not None:
            table = {row.PID: (row.AGE, row.SEX) for row in df.itertuples()}
            for d in dataset:
                age_sex = table.get(d["pid"])
                d["AGE"], d["SEX"] = age_sex if age_sex else (None, None)

    if load_voxels:
        for d in dataset:
            d["voxel"] = read_voxel(d["path"])
    return dataset
