"""Dataset preprocessing CLI (counterpart of
``mode_diffusion_policy_tpu/data/preprocess.py``; copied): pack one npz key
across all episode files of a split into a single npy plus a name index,
with a random spot check.

A redesign of the reference's ``preprocess/extract_by_key.py:43-178``,
which removes the per-frame action reads from training (README.md:73-76);
a thread pool reads the npz files. ``ExtendedDiskDataset`` with
``use_extracted_rel_actions`` reads its output.

Usage:
    python -m mode_diffusion_policy_tpu_torch.data.preprocess \
        --in-root /data/calvin/task_D_D/training --extract-key rel_actions
"""
from __future__ import annotations

import argparse
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np


def list_episode_files(in_root: str) -> List[Tuple[int, str]]:
    """(episode index, path) for every episode_*.npz, sorted by index."""
    out = []
    pat = re.compile(r"episode_(\d+)\.npz$")
    for name in os.listdir(in_root):
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(in_root, name)))
    out.sort()
    return out


def extract_by_key(in_root: str, extract_key: str = "rel_actions",
                   out_dir: str | None = None, workers: int = 8,
                   force: bool = False, verify_samples: int = 20) -> str:
    """Pack ``extract_key`` from every episode npz into
    ``<out_dir>/ep_<key>.npy`` + ``ep_npz_names.list``. Returns out_dir."""
    in_root = str(in_root)
    out_dir = out_dir or os.path.join(in_root, "extracted")
    os.makedirs(out_dir, exist_ok=True)
    out_npy = os.path.join(out_dir, f"ep_{extract_key}.npy")
    out_list = os.path.join(out_dir, "ep_npz_names.list")
    if os.path.exists(out_npy) and not force:
        print(f"{out_npy} exists; use force=True to overwrite")
        return out_dir

    files = list_episode_files(in_root)
    if not files:
        raise FileNotFoundError(f"no episode_*.npz under {in_root}")

    def load_one(item):
        _, path = item
        with np.load(path, allow_pickle=True) as data:
            return np.asarray(data[extract_key])

    with ThreadPoolExecutor(max_workers=workers) as pool:
        arrays = list(pool.map(load_one, files))
    stacked = np.stack(arrays)
    np.save(out_npy, stacked)
    with open(out_list, "w") as f:
        for idx, _ in files:
            f.write(f"{idx}\n")
    print(f"wrote {stacked.shape} -> {out_npy}")

    # spot-check verification (reference extract_by_key.py:104-122)
    rng = np.random.default_rng(0)
    for j in rng.choice(len(files), min(verify_samples, len(files)),
                        replace=False):
        with np.load(files[j][1], allow_pickle=True) as data:
            np.testing.assert_array_equal(stacked[j], data[extract_key])
    print(f"verified {min(verify_samples, len(files))} random episodes")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in-root", required=True)
    p.add_argument("--extract-key", default="rel_actions")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    extract_by_key(args.in_root, args.extract_key, args.out_dir, args.workers,
                   args.force)


if __name__ == "__main__":
    main()
