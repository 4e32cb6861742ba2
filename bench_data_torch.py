"""Host data-pipeline benchmark of the PyTorch port: can the host feed the
train step?

    python3 bench_data_torch.py [--data-root <CALVIN dir>]

Counterpart of ``bench_data.py`` for ``mode_diffusion_policy_tpu_torch``.
It measures the host loader end to end in samples/s: dataset window
assembly (``data/calvin_dataset.py``: FNV-validated windows, padding) ->
the optional POSIX shared-memory episode cache (``data/shm_cache.py``) ->
collate -> the prefetch thread, and at ``BENCH_DATA_WORKERS`` >= 1 the
batch-assembly worker processes (``data/datamodule.py``), on a synthetic
CALVIN-format dataset (``tests/calvin_fixture.py``, 8 episodes of 64
frames a split) or a real one via ``--data-root``. Augmentation runs on
the device inside the train step (``ops/image.py``), so the host only
moves uint8 bytes.

One warm-up batch of epoch 0, then ``BENCH_DATA_BATCHES`` timed batches
from epoch 1 on, each epoch's iterator closed before the next one starts
and after the last batch (closing stops the worker processes). Prints one
JSON line: {"metric": "host_loader_samples_per_s", "value": <samples/s>,
"unit", "batch", "shm_cache", "workers"}. Knobs: BENCH_DATA_BATCH (32),
BENCH_DATA_BATCHES (30), BENCH_DATA_SHM (1), BENCH_DATA_HW (200, the
synthetic frames' size), BENCH_DATA_WORKERS (0 = inline assembly; N >= 1
worker processes). A host benchmark: it runs on the CPU as on the GPU's
host, needs no card, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synth_dataset(root: Path, hw: int, n_episodes: int, ep_len: int):
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from calvin_fixture import make_calvin_dataset
    return make_calvin_dataset(root, n_episodes=n_episodes, ep_len=ep_len,
                               hw=hw, splits=("training", "validation"))


def main(argv=None, env=None):
    """Run the benchmark; the knobs come from ``env`` (``os.environ`` by
    default). Prints the JSON line and returns it as a dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=None,
                   help="real CALVIN dir; default: synthetic fixture")
    args = p.parse_args(argv)
    env = os.environ if env is None else env

    from mode_diffusion_policy_tpu_torch.data.datamodule import (
        CalvinDataModule)

    B = int(env.get("BENCH_DATA_BATCH", "32"))
    n_batches = int(env.get("BENCH_DATA_BATCHES", "30"))
    use_shm = env.get("BENCH_DATA_SHM", "1") == "1"
    hw = int(env.get("BENCH_DATA_HW", "200"))
    workers = int(env.get("BENCH_DATA_WORKERS", "0"))

    with tempfile.TemporaryDirectory() as tmp:
        if args.data_root:
            root = Path(args.data_root)
        else:
            # enough episodes that the index sweep wraps several times
            root = synth_dataset(Path(tmp) / "calvin", hw=hw, n_episodes=8,
                                 ep_len=64)
            log(f"synthetic CALVIN fixture at {root} ({hw}x{hw} frames)")
        t0 = time.perf_counter()
        dm = CalvinDataModule(str(root), batch_size=B, num_workers=workers,
                              use_shm_cache=use_shm).setup()
        try:
            setup_s = time.perf_counter() - t0
            log(f"setup (incl. shm preload: {use_shm}): {setup_s:.1f}s, "
                f"{len(dm.train_dataset)} train examples")
            sps, got, dt = timed_batches(dm, B, n_batches)
        finally:
            dm.close()
    log(f"{got} batches of {B} in {dt:.2f}s")
    out = {"metric": "host_loader_samples_per_s", "value": sps,
           "unit": "samples/s", "batch": B, "shm_cache": use_shm,
           "workers": workers}
    print(json.dumps(out), flush=True)
    return out


def timed_batches(dm, B, n_batches):
    """(samples/s, batches, seconds) of ``n_batches`` train batches after
    one warm-up batch. Every iterator is closed when it is left: an
    iterator abandoned mid-epoch would keep its worker processes blocked
    on their full queues until the interpreter's exit."""
    it = dm.train_batches(epoch=0)
    next(it)
    it.close()
    got, epoch = 0, 1
    t0 = time.perf_counter()
    it = dm.train_batches(epoch=epoch)
    try:
        while got < n_batches:
            try:
                batch = next(it)
            except StopIteration:
                it.close()
                epoch += 1
                it = dm.train_batches(epoch=epoch)
                continue
            if batch["rgb_static"].dtype.kind not in "uif":
                raise TypeError(f"frames of {batch['rgb_static'].dtype}")
            got += 1
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return got * B / dt, got, dt


if __name__ == "__main__":
    main()
