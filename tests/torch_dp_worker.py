"""One rank of the 2-rank gloo world of ``tests/test_torch_data_parallel.py``,
``tests/test_torch_zero1.py`` and ``tests/test_torch_dp_trainer.py``, and
the launcher that spawns it.

``World(suite, run_dir)`` writes nothing itself: the test has put
the inputs in ``<run_dir>/inputs.pt``. It starts ``world`` processes of
``python tests/torch_dp_worker.py <suite> <rank> <world> <port>
<run_dir>``, each with the torchrun variables set, so that the rank
starts its group through ``parallel.mesh.init_distributed("gloo",
device="cpu")``, runs every check of its suite and writes its results to
``<run_dir>/rank<r>.pt``; ``World.results(timeout)`` waits for them
(the test computes its JAX references meanwhile). The wait has its own
timeout: a collective that hangs fails the test instead of eating the
suite's time.
This module imports no JAX: a rank runs the port only.
"""
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """``world`` ranks of ``suite`` started on ``run_dir``'s inputs;
    ``results()`` waits for them."""

    def __init__(self, suite, run_dir, world=2):
        from torch_threads import THREADS
        self.run_dir, self.world = str(run_dir), world
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([ROOT,
                                             env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = str(THREADS)
        # the optimizer's 100 MB temporaries stay in the heap: with glibc's
        # defaults each is a fresh mapping, and its page faults doubled a
        # CPU step's time
        env.update(MALLOC_MMAP_THRESHOLD_=str(1 << 30),
                   MALLOC_TRIM_THRESHOLD_=str(1 << 30))
        self.procs = []
        for rank in range(world):
            log = open(os.path.join(self.run_dir, f"rank{rank}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(rank),
                 str(world), str(port), self.run_dir], env=env, cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT), log))
        self.started = time.monotonic()

    def results(self, timeout=120.0):
        """Each rank's results. Raises (with the ranks' output) if a rank
        fails or is still running ``timeout`` seconds after the start;
        every rank is stopped before it returns."""
        import torch
        deadline = self.started + timeout
        failed = None
        try:
            for rank, (p, _) in enumerate(self.procs):
                try:
                    rc = p.wait(timeout=max(1.0,
                                            deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed = f"rank {rank} did not finish in {timeout} s"
                    break
                if rc != 0:
                    failed = f"rank {rank} exited with {rc}"
                    break
        finally:
            self.stop()
        if failed:
            logs = "".join(
                f"\n--- rank {r} ---\n" + open(os.path.join(
                    self.run_dir, f"rank{r}.log")).read()[-6000:]
                for r in range(self.world))
            raise AssertionError(failed + logs)
        return [torch.load(os.path.join(self.run_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]

    def stop(self):
        for p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


# ---------------------------------------------------------------------------
# the rank's side: large arrays go back from rank 0 only, as f32; the
# ranks' agreement travels as digests of the tensors' bytes
# ---------------------------------------------------------------------------

def _f32(d):
    return {n: t.detach().float().cpu().numpy().copy() for n, t in d.items()}


def _digest(d):
    import hashlib

    import torch
    return {n: hashlib.sha1(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest() for n, t in d.items()}


def _update(params, p0):
    """The parameters minus their start, in float64, stored as f32."""
    return {n: (t.detach().double() - p0[n].double()).float().numpy()
            for n, t in params.items()}


def _agent(inp, dtype, **over):
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgentConfig
    from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
    cfg = MoDEAgentConfig(**dict(inp["cfg"], dtype=dtype, **over))
    agent = from_jax_params(inp["variables"], cfg, device="cpu")
    return agent.double() if dtype == torch.float64 else agent


def _state(agent, inp, mesh=None, **kw):
    import torch
    from mode_diffusion_policy_tpu_torch.training import optim
    from mode_diffusion_policy_tpu_torch.training.state import TrainState
    opt, _ = optim.make_optimizer(dict(agent.named_parameters()),
                                  **inp["opt_kw"], **kw.pop("opt", {}))
    state = TrainState.create(agent, opt, torch.Generator().manual_seed(
        inp.get("seed", 0)), zero1=mesh, **kw)
    return opt, state


def _rows(x, mesh):
    import torch
    from mode_diffusion_policy_tpu_torch.parallel.mesh import batch_sharding
    t = torch.as_tensor(x)
    return t[batch_sharding(mesh, len(t))]


def _draws(d, mesh, dtype):
    return {"sigma": _rows(d["sigma"], mesh).to(dtype),
            "noise": _rows(d["noise"], mesh).to(dtype),
            "gumbel": [_rows(g, mesh).to(dtype) for g in d["gumbel"]]}


def _steps(mesh, inp, dtype, **over):
    """STEPS train steps on this rank's rows of the global batch and
    draws: the losses, the load-balancing term and expert counts of step
    1; digests of the reduced gradient, the running statistics (step 1)
    and the parameters (steps 1 and STEPS); on rank 0 also the gradient,
    the statistics and the parameters' updates."""
    import torch
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    agent = _agent(inp, dtype, **over)
    p0 = {n_: p.detach().clone() for n_, p in agent.named_parameters()}
    opt, state = _state(agent, inp)
    step = make_train_step(agent, opt, log_grad_norms=False, device="cpu",
                           mesh=mesh)
    batch = {k: _rows(v, mesh).to(dtype) for k, v in inp["batch"].items()}
    heavy = mesh.rank == 0
    out = {"loss": [], "digest": {}, "update": {}}
    for i in range(STEPS):
        _, m = step(state, batch, draws=_draws(inp["draws"], mesh, dtype))
        out["loss"].append(float(m["train/total_loss"]))
        if i == 0:
            out["lb"] = float(m["train/load_balancing_loss"])
            out["expert_counts"] = m["expert_counts"].numpy()
            out["digest"]["grads"] = _digest(state.grads)
            out["digest"]["batch_stats"] = _digest(state.batch_stats)
            out["batch_stats"] = {k: t.double().numpy().copy()
                                  for k, t in state.batch_stats.items()}
            if heavy:
                out["grads"] = _f32(state.grads)
        if i + 1 in (1, STEPS):
            out["digest"][i + 1] = _digest(state.params)
            if heavy:
                out["update"][i + 1] = _update(state.params, p0)
    return out


def _local_lb(mesh, inp):
    """This rank's load-balancing term on its own rows, outside a
    data-parallel step (what a rank would compute without the
    reduction)."""
    import torch
    agent = _agent(inp, torch.float64)
    batch = {k: _rows(v, mesh).double() for k, v in inp["batch"].items()}
    _, (m, _) = agent.training_loss(batch, None,
                                    **_draws(inp["draws"], mesh,
                                             torch.float64))
    return float(m["train/load_balancing_loss"].detach())


def _part_rel(got, want, dit):
    import numpy as np
    names = [n for n in want if n.startswith("inner_model.") == dit]
    num = sum(np.linalg.norm(got[n].astype(np.float64) - want[n]) ** 2
              for n in names)
    den = sum(np.linalg.norm(want[n].astype(np.float64)) ** 2
              for n in names)
    return float((num / den) ** 0.5)


def _invariance(mesh, inp, steps=STEPS, **over):
    """``steps`` steps with the dropouts, the goal drop, the Gumbel
    routing and the camera augmentations (uint8 frames) on: the 2-rank
    world and (rank 0) one rank at the same global batch (a world of 1),
    from the same seed. Whether the generators' states agree after each
    step, the parameters' digests, and (rank 0) the relative L2 distance
    of the 2-rank update from the 1-rank one over the DiT and the
    encoders."""
    import torch
    from mode_diffusion_policy_tpu_torch.parallel.mesh import Mesh
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    from mode_diffusion_policy_tpu_torch.training_common import \
        make_train_preprocess
    pre = make_train_preprocess(inp["pipelines"])
    runs = {}
    worlds = [("two", mesh)] + ([("one", Mesh(device=torch.device("cpu")))]
                                if mesh.rank == 0 else [])
    for name, m in worlds:
        agent = _agent(inp, torch.float32, **inp["drop_cfg"], **over)
        p0 = {n: p.detach().clone() for n, p in agent.named_parameters()}
        opt, state = _state(agent, inp)
        step = make_train_step(agent, opt, log_grad_norms=False,
                               device="cpu", preprocess_fn=pre, mesh=m)
        rng = []
        for b in inp["raw_batches"][:steps]:
            batch = ({k: torch.as_tensor(v) for k, v in b.items()}
                     if m.size == 1 else {k: _rows(v, m)
                                          for k, v in b.items()})
            step(state, batch)
            rng.append(state.rng.get_state())
        runs[name] = {"update": _update(state.params, p0), "rng": rng,
                      "digest": _digest(state.params)}
    out = {"digest": runs["two"]["digest"]}
    if "one" in runs:
        one, two = runs["one"], runs["two"]
        out["rng_equal"] = [bool(torch.equal(a, b))
                            for a, b in zip(one["rng"], two["rng"])]
        out["distance"] = {
            part: _part_rel(two["update"], one["update"], dit)
            for part, dit in (("dit", True), ("encoders", False))}
    return out


def _trainer(mesh, inp, log_dir, **kw):
    import torch
    from mode_diffusion_policy_tpu_torch.training.loop import Trainer
    from mode_diffusion_policy_tpu_torch.training_common import \
        make_train_preprocess
    agent = _agent(inp, torch.float32)
    kw.setdefault("bf16_full_state", True)
    return Trainer(agent, log_dir=log_dir, device="cpu", mesh=mesh,
                   optimizer_kwargs=inp["opt_kw"], limit_val_batches=1,
                   preprocess_fn=make_train_preprocess(inp["pipelines"]),
                   **kw)


def _fit_cases(mesh, inp, run_dir):
    """Trainer.fit on both ranks: uneven shards (rank 0 holds one batch
    more), the files each rank writes, a SIGTERM sent to rank 1 alone and
    the resume from its checkpoint."""
    import signal

    import torch
    from mode_diffusion_policy_tpu_torch.training import loop
    out = {}
    writes = []
    orig = loop.CheckpointManager._write

    def counting(self, *a, **k):
        writes.append(a[1])
        return orig(self, *a, **k)

    loop.CheckpointManager._write = counting
    raw = inp["raw_batches"]
    mine = [{k: _rows(v, mesh) for k, v in b.items()} for b in raw]
    n_mine = len(mine) if mesh.rank == 0 else len(mine) - 1
    log_dir = os.path.join(run_dir, "fit")
    t = _trainer(mesh, inp, log_dir, max_epochs=1,
                 limit_train_batches=10)
    state = t.setup(seed=0)
    state = t.fit(state, lambda: iter(mine[:n_mine]),
                  lambda: iter(mine[:1]))
    out["uneven"] = {"step": state.step, "batches": n_mine,
                     "writes": list(writes),
                     "logger_open": t.logger._jsonl is not None,
                     "digest": _digest(state.params),
                     "files": sorted(os.listdir(log_dir))}
    t.logger.close()
    writes.clear()

    log_dir = os.path.join(run_dir, "sigterm")

    def gen():
        for i, b in enumerate(mine):
            if i == 1 and mesh.rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    t = _trainer(mesh, inp, log_dir, max_epochs=3, limit_train_batches=10)
    s1 = t.setup(seed=0)
    s1 = t.fit(s1, lambda: gen())
    t.logger.close()
    t2 = _trainer(mesh, inp, log_dir, max_epochs=3, limit_train_batches=10)
    s2 = t2.setup(seed=0)
    t2.logger.close()
    out["sigterm"] = {
        "step": s1.step, "latest": t.ckpt.latest_step(),
        "resumed": t2.resumed, "resumed_step": s2.step,
        "resumed_equal": all(torch.equal(s2.params[n], p)
                             for n, p in s1.params.items()),
        "writes": list(writes)}
    loop.CheckpointManager._write = orig
    return out


def _cli_case(mesh, inp, run_dir):
    """``training_calvin.main`` on the tiny store, on both ranks (the
    process group is up: the CLI takes its world); the rows of every
    batch this rank stepped on."""
    from mode_diffusion_policy_tpu_torch import training_calvin
    from mode_diffusion_policy_tpu_torch.training import loop
    rows = []
    orig = loop.shard_batch

    def recording(batch, where):
        rows.append(len(batch["actions"]))
        return orig(batch, where)

    loop.shard_batch = recording
    log_dir = os.path.join(run_dir, "cli")
    try:
        run = training_calvin.main(inp["cli_argv"] + [f"log_dir={log_dir}"])
    finally:
        loop.shard_batch = orig
    mesh_seen = run.trainer.mesh
    return {"step": run.state.step, "size": mesh_seen.size,
            "rank": mesh_seen.rank, "run_dir": str(run.run_dir),
            "digest": _digest(run.state.params), "rows": rows,
            "ckpt": run.trainer.ckpt.latest_step(),
            "files": sorted(os.listdir(run.run_dir))}


def _timed(out, name, fn, *args, **kw):
    t0 = time.perf_counter()
    out[name] = fn(*args, **kw)
    print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)


def data_parallel_suite(mesh, inp, run_dir):
    import torch
    out = {"mesh": (mesh.size, mesh.rank, mesh.local_rank, mesh.local_size,
                    mesh.backend)}
    _timed(out, "f64", _steps, mesh, inp, torch.float64)
    # the f32 run rematerializes the encoders: their reductions are issued
    # again in the backward pass
    _timed(out, "f32", _steps, mesh, inp, torch.float32, encoder_remat=True)
    _timed(out, "local_lb", _local_lb, mesh, inp)
    _timed(out, "invariance", _invariance, mesh, inp)
    # the grouped MoE draws its expert dropout over the expert-sorted
    # pairs of the global batch (ops/moe._global_pair_rows)
    _timed(out, "invariance_grouped", _invariance, mesh, inp, 1,
           use_grouped_moe=True)
    return out


def trainer_suite(mesh, inp, run_dir):
    out = {}
    _timed(out, "fit", _fit_cases, mesh, inp, run_dir)
    _timed(out, "cli", _cli_case, mesh, inp, run_dir)
    return out


def _held(state, zero1):
    """The state's ZeRO-1 record after its steps: digests of the gathered
    EMA and first moment, the generator's state, and the elements of the
    moments and the EMA this rank holds beside their whole count."""
    from mode_diffusion_policy_tpu_torch.training.optim import ShardedFlats

    def held(x):
        return x.numel() if isinstance(x, ShardedFlats) else sum(
            t.numel() for t in x.flats)

    mu, nu, ema = state.opt_state.mu, state.opt_state.nu, state.ema_params
    return {"ema": _digest(state.full_ema()),
            "mu": _digest(mu.full() if zero1 else mu),
            "held": {"mu": held(mu), "nu": held(nu), "ema": held(ema)},
            "whole": sum(g.numel for g in mu.layout.groups),
            "sharded": [isinstance(x, ShardedFlats) for x in (mu, nu, ema)],
            "dtypes": sorted({str(t.dtype) for t in mu.flats}),
            "rng": state.rng.get_state()}


def _zero1_steps(mesh, inp, zero1):
    """STEPS 2-rank steps with the f32 state from the same weights and
    draws, replicated or ZeRO-1: the parameters' digests after each step
    and the state's record (``_held``)."""
    import torch
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    agent = _agent(inp, torch.float32)
    opt, state = _state(agent, inp, mesh if zero1 else None)
    step = make_train_step(agent, opt, log_grad_norms=False, device="cpu",
                           mesh=mesh)
    batch = {k: _rows(v, mesh) for k, v in inp["batch"].items()}
    params = []
    for _ in range(STEPS):
        step(state, batch, draws=_draws(inp["draws"], mesh, torch.float32))
        params.append(_digest(state.params))
    return dict(_held(state, zero1), params=params)


def _zero1_trainer(mesh, inp, run_dir):
    """Trainer.fit for STEPS steps with the bf16 stochastic-rounding state
    (the dropouts, the augmentations and the rounding bits drawn from the
    generator), ZeRO-1 and replicated, each ending in a checkpoint: the
    parameters' digests after each step and the state's record; and a
    one-rank checkpoint the test wrote, restored into a ZeRO-1 Trainer:
    whether its gathered state equals the file's tensors bit for bit."""
    import torch
    from mode_diffusion_policy_tpu_torch.training.optim import ShardedFlats
    out = {}
    raw = inp["raw_batches"]
    mine = [{k: _rows(v, mesh) for k, v in b.items()} for b in raw]
    for name, zero1 in (("zero1", True), ("replicated", False)):
        t = _trainer(mesh, inp, os.path.join(run_dir, name), max_epochs=1,
                     limit_train_batches=10, zero1=zero1,
                     bf16_full_state=True)
        s = t.setup(seed=0)
        params, step = [], t._train_step

        def recording(state, batch):
            state, m = step(state, batch)
            params.append(_digest(state.params))
            return state, m

        t._train_step = recording
        s = t.fit(s, lambda: iter(mine))
        t.logger.close()
        out[name] = dict(_held(s, zero1), step=s.step, params=params,
                         ckpt=t.ckpt.latest_step(),
                         path=os.path.join(t.ckpt.ckpt_dir, str(s.step),
                                           t.ckpt.FILE))
    t = _trainer(mesh, inp, inp["one_rank_run"], max_epochs=1, zero1=True,
                 bf16_full_state=True)
    s = t.setup(seed=0)
    t.logger.close()
    saved = torch.load(os.path.join(t.ckpt.ckpt_dir, str(s.step),
                                    t.ckpt.FILE), weights_only=False)

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)

    out["restored"] = {
        "resumed": t.resumed, "step": s.step,
        "sharded": isinstance(s.opt_state.mu, ShardedFlats),
        "mu": same(s.opt_state.mu.full(), saved["opt_state"]["mu"]),
        "nu": same(s.opt_state.nu.full(), saved["opt_state"]["nu"]),
        "ema": same(s.full_ema(), saved["ema_params"]),
        "params": same(s.params, saved["params"])}
    return out


def zero1_suite(mesh, inp, run_dir):
    """The f32 state through ``make_train_step``; the bf16 state through
    ``Trainer.fit``."""
    out = {}
    for zero1 in (False, True):
        _timed(out, zero1, _zero1_steps, mesh, inp, zero1)
    _timed(out, "trainer", _zero1_trainer, mesh, inp, run_dir)
    return out


SUITES = {"data_parallel": data_parallel_suite, "zero1": zero1_suite,
          "trainer": trainer_suite}


def main(argv):
    suite, rank, world, port, run_dir = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world, MASTER_ADDR="localhost",
                      MASTER_PORT=port)
    import torch
    from mode_diffusion_policy_tpu_torch.parallel.mesh import (
        destroy_distributed, init_distributed)
    mesh = init_distributed("gloo", device="cpu")
    inp = torch.load(os.path.join(run_dir, "inputs.pt"), weights_only=False)
    out = SUITES[suite](mesh, inp, run_dir)
    torch.save(out, os.path.join(run_dir, f"rank{rank}.pt"))
    destroy_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
