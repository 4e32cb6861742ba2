"""Count non-finite training losses of the bf16 LIBERO CLI on the CPU, for
the JAX package and the PyTorch port, at one configuration and seed.

    JAX_PLATFORMS=cpu python3 scripts/bf16_nan_count.py [--runs 20] [--steps 6]
        [--which both|jax|port] [--jobs 1] [--out counts.json]

The configuration is the LIBERO training CLI test's
(``tests/test_torch_libero.py::test_training_libero_cli_on_the_cpu``): the
shipped ``conf/config_libero.yaml`` (seed 42) with a one-layer DiT 64 wide
with 2 heads, both FiLM-ResNet-50 encoders, batches of 4, the static camera
at 32 px and the gripper at 16 px (1 x 1 maps at the encoder's end), on two
fixture tasks (``tests/test_libero.py::make_libero_hdf5``), but in the
shipped bf16 precision. Each run is a fresh process of the package's
``training_libero.main`` for ``--steps`` epochs of one step: both trainers
log the loss of each epoch's first step, so every step's loss is read
from the run's ``metrics.jsonl``. Prints, per package, the runs, the
steps, the non-finite losses, the runs that had one and the runs whose
losses equal the most common run's (``identical_runs``), as one JSON
line. ``--jobs`` runs that many processes at a time (load and threads
change how often an allocator-dependent fault shows). Needs ``h5py`` for
the fixture store.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TASKS = ("SCENE1_open_the_top_drawer_demo.hdf5",
         "SCENE2_put_the_bowl_on_the_plate_demo.hdf5")


def overrides(store, log_dir, steps):
    return [f"root_data_dir={store}", f"log_dir={log_dir}",
            "model.latent_dim=64", "model.model.inner_model.n_layers=1",
            "model.model.inner_model.n_heads=2", "batch_size=4",
            "trainer.precision=bf16", f"trainer.max_epochs={steps}",
            "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
            "callbacks.rollout_lh.rollout_freq=1000"] + [
        f"datamodule.transforms.{split}.{cam}.0.size={size}"
        for split in ("train", "val")
        for cam, size in (("rgb_static", 32), ("rgb_gripper", 16))]


def one_run(which, store, log_dir, steps):
    """One CLI run in this process; returns the losses of its steps."""
    sys.path.insert(0, str(ROOT))
    ov = overrides(store, log_dir, steps)
    if which == "port":
        from mode_diffusion_policy_tpu_torch import training_libero
        training_libero.main(ov + ["device=cpu"])
    else:
        from mode_diffusion_policy_tpu import training_libero
        training_libero.main(ov)
    losses = []
    for path in sorted(pathlib.Path(log_dir).rglob("metrics.jsonl")):
        for line in open(path):
            rec = json.loads(line)
            if "train/total_loss" in rec:
                losses.append(float(rec["train/total_loss"]))
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--which", default="both",
                   choices=("both", "jax", "port"))
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--out", default=None)
    p.add_argument("--one", nargs=3, metavar=("WHICH", "STORE", "LOG_DIR"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(one_run(*args.one, args.steps)))
        return None
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from test_libero import make_libero_hdf5
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = pathlib.Path(tmp) / "store"
        (store / "libero_10").mkdir(parents=True)
        for seed, name in enumerate(TASKS):
            make_libero_hdf5(store / "libero_10" / name, seed=seed)
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        for which in (("jax", "port") if args.which == "both"
                      else (args.which,)):
            rec = out[which] = {"runs": 0, "steps": 0, "non_finite": 0,
                                "runs_with_non_finite": 0, "seconds": 0.0,
                                "losses": []}

            def run(r, which=which):
                t = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, __file__, "--steps", str(args.steps),
                     "--one", which, str(store), f"{tmp}/{which}{r}"],
                    capture_output=True, text=True, env=env, cwd=ROOT)
                # each run's checkpoints take gigabytes: keep none
                shutil.rmtree(f"{tmp}/{which}{r}", ignore_errors=True)
                if proc.returncode:
                    raise SystemExit(f"{which} run {r} failed:\n"
                                     f"{proc.stderr[-3000:]}")
                losses = json.loads(proc.stdout.strip().splitlines()[-1])
                print(f"{which} run {r}: losses {losses}", file=sys.stderr,
                      flush=True)
                return losses, time.perf_counter() - t

            with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
                done = list(pool.map(run, range(args.runs)))
            for losses, seconds in done:
                bad = sum(not math.isfinite(x) for x in losses)
                rec["runs"] += 1
                rec["steps"] += len(losses)
                rec["non_finite"] += bad
                rec["runs_with_non_finite"] += bad > 0
                rec["seconds"] += seconds
                rec["losses"].append(losses)
            counts = collections.Counter(repr(x) for x in rec["losses"])
            rec["identical_runs"] = counts.most_common(1)[0][1]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
