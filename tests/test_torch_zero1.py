"""The port's ZeRO-1 state on the CPU (counterpart of the JAX package's
``zero1_state_sharding``, ``tests/test_training.py``'s two ZeRO-1 tests): a
2-rank gloo world, spawned once (``tests/torch_dp_worker.py``), where
each rank keeps its half of every flat buffer of the Adam moments and the
EMA, updates its half of the parameters and all-gathers them.

The weights are numpy-made for the JAX agent's tree and enter the port
through ``from_jax_params`` (a 2-layer DiT 64 wide with 4 heads, cond 8,
FiLM-ResNet-18 encoders at 32 px, global batch 8). Checked: three steps
with the f32 state (``make_train_step``, the draws given) and with the
bf16 stochastic-rounding state (``Trainer.fit``: dropouts, augmentations
and rounding bits from the generator) give parameters, gathered EMA and
moments bit-equal to the replicated 2-rank run's (the rounding bits
depend on the element's position, not on the sharding), each rank
holding half of the moments' and the EMA's elements; the ZeRO-1 and the
replicated ``Trainer`` write the same checkpoint, entry for entry, and it
restores into a one-rank ``Trainer`` and continues; and a one-rank
checkpoint restores into a ZeRO-1 ``Trainer`` on 2 ranks.
"""
import shutil

import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgentConfig
from mode_diffusion_policy_tpu_torch.parallel.mesh import Mesh
from mode_diffusion_policy_tpu_torch.training.loop import Trainer
from mode_diffusion_policy_tpu_torch.training_common import (
    DEFAULT_PIPELINES, make_train_preprocess)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from test_torch_data_parallel import (DIMS, LOSS_KW, NO_DROP, OPT_KW,
                                      _batch, _draws, _random_variables,
                                      _raw_batches)
from torch_dp_worker import World
from torch_threads import two_torch_threads  # noqa: F401

PIPES = {k: dict(v, size=32) for k, v in DEFAULT_PIPELINES.items()}


def _trainer(v, log_dir, epochs):
    """A one-rank Trainer (a world of 1 on the CPU) of the bf16 state."""
    agent = from_jax_params(v, MoDEAgentConfig(**DIMS, **NO_DROP, **LOSS_KW),
                            device="cpu")
    return Trainer(agent, log_dir=str(log_dir), device="cpu",
                   mesh=Mesh(device=torch.device("cpu")), max_epochs=epochs,
                   optimizer_kwargs=OPT_KW, bf16_full_state=True,
                   preprocess_fn=make_train_preprocess(PIPES))


def _batches(raw):
    return [{k: torch.as_tensor(x) for k, x in b.items()} for b in raw]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A one-rank checkpoint (one step), then the 2-rank world's results;
    the run directory is removed at the end."""
    tmp = tmp_path_factory.mktemp("zero1")
    v = _random_variables(JAgent(JCfg(**DIMS)))
    raw = _raw_batches()
    t = _trainer(v, tmp / "one_rank", 1)
    t.fit(t.setup(seed=0), lambda: iter(_batches(raw[:1])))
    t.logger.close()
    torch.save({"variables": v, "cfg": dict(**DIMS, **NO_DROP, **LOSS_KW),
                "batch": _batch(), "draws": _draws(), "opt_kw": OPT_KW,
                "raw_batches": raw, "pipelines": PIPES,
                "one_rank_run": str(tmp / "one_rank")}, tmp / "inputs.pt")
    yield v, raw, tmp, World("zero1", tmp).results(timeout=240.0)
    shutil.rmtree(tmp, ignore_errors=True)


def _runs(rank, bf16):
    """(replicated, ZeRO-1) records of one rank: the bf16 state's from the
    Trainer, the f32 state's from the train step."""
    if bf16:
        return rank["trainer"]["replicated"], rank["trainer"]["zero1"]
    return rank[False], rank[True]


def _equal(a, b):
    """Two checkpoint payloads agree entry for entry (tensors bit for bit,
    in the same dtype)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_sr"])
def test_zero1_steps_are_bit_equal_to_replicated(world, bf16):
    """Three steps on 2 ranks: the ZeRO-1 parameters after every step, the
    gathered EMA and first moment and the generator's state equal the
    replicated run's bit for bit, on both ranks (and both ranks agree)."""
    *_, ranks = world
    for r in ranks:
        rep, z = _runs(r, bf16)
        assert z["sharded"] == [True] * 3 and rep["sharded"] == [False] * 3
        assert len(z["params"]) == len(rep["params"]) == 3
        for a, b in zip(z["params"], rep["params"]):
            assert a == b
        assert z["ema"] == rep["ema"] and z["mu"] == rep["mu"]
        assert torch.equal(z["rng"], rep["rng"])
        assert z["dtypes"] == (["torch.bfloat16"] if bf16
                               else ["torch.float32"])
    assert _runs(ranks[0], bf16)[1]["params"] == \
        _runs(ranks[1], bf16)[1]["params"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_sr"])
def test_each_rank_holds_half_of_moments_and_ema(world, bf16):
    """Counting elements: under ZeRO-1 each rank holds ceil(n / 2) of
    every flat buffer's n elements of mu, nu and the EMA (a padded half);
    replicated, all of them."""
    *_, ranks = world
    for r in ranks:
        rep, z = _runs(r, bf16)
        whole = z["whole"]
        for what in ("mu", "nu", "ema"):
            assert rep["held"][what] == whole
            held = z["held"][what]
            # one padding element at most per flat buffer
            assert 0 <= 2 * held - whole <= 8, (what, held, whole)
        print(f"{'bf16' if bf16 else 'f32'} state: each rank holds "
              f"{z['held']['mu']} of {whole} moment elements")


def test_zero1_checkpoint_restores_on_one_rank(world):
    """The ZeRO-1 and the replicated 2-rank Trainer (bf16 state, three
    steps) end with the same parameters and write the same checkpoint,
    entry for entry (step, epoch, parameters, statistics, moments and
    their count, EMA, generator), so the replicated run's resume is the
    same computation. The ZeRO-1 checkpoint restores into a one-rank
    Trainer, which resumes at step 3 and continues two steps at the global
    batch."""
    v, raw, tmp, ranks = world
    tz, tr = ranks[0]["trainer"]["zero1"], ranks[0]["trainer"]["replicated"]
    assert tz["step"] == tr["step"] == tz["ckpt"] == 3
    assert tz["params"][-1] == tr["params"][-1]
    assert ranks[1]["trainer"]["zero1"]["params"][-1] == tz["params"][-1]
    saved = [torch.load(t["path"], weights_only=False) for t in (tz, tr)]
    assert _equal(saved[0], saved[1])
    t = _trainer(v, tmp / "zero1", 2)
    s = t.setup(seed=0)
    assert t.resumed and s.step == 3 and s.epoch == 1
    assert _equal(dict(s.params), saved[0]["params"])
    s = t.fit(s, lambda: iter(_batches(raw[:2])))
    t.logger.close()
    assert s.step == 5


def test_one_rank_checkpoint_restores_into_zero1(world):
    """A checkpoint written by one rank restores into a ZeRO-1 Trainer on 2
    ranks: its gathered moments and EMA, and its parameters, equal the
    file's bit for bit."""
    *_, ranks = world
    for r in ranks:
        got = r["trainer"]["restored"]
        assert got["resumed"] and got["step"] == 1 and got["sharded"], got
        assert got["mu"] and got["nu"] and got["ema"] and got["params"], got
