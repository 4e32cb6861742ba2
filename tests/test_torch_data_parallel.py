"""The port's data parallelism on the CPU: a 2-rank gloo world, spawned once
(``tests/torch_dp_worker.py``), against JAX's train step over the global
batch on a 2-device mesh of the 8 virtual CPU devices.

Both packages start from the same numpy-made weights (``from_jax_params``)
at small shapes: a 2-layer DiT 64 wide with 4 heads (the port tests'
embed 64 / 2 layers / 4 heads), the JAX training tests' cond of 8 and
FiLM-ResNet-18 encoders at 32 px (``tiny_setup``), global batch 8, each
rank 4 rows. (At ``tiny_setup``'s 32 wide DiT with 2 heads the port's
float64 step, on one rank or two, lies 0.83 times as far from JAX's x64
step as JAX's own f32 step does: JAX keeps f32 casts under x64, and the
float64 rule below, half as far, cannot hold there.) Sigma, noise and the
Gumbel noise are the JAX step's, patched to constants (each rank passes
its rows); the dropouts are off where outputs are compared with JAX.

Checked: the loss, every gradient leaf after the reduction, the BatchNorm
running statistics, the global load-balancing term (which the mean of the
ranks' own terms is not) and the expert counts, the parameters after 1
and 3 steps; remat under 2 ranks (the f32 run: no hang, the statistics
moved once);
that 2 ranks draw what 1 rank at the global batch draws (dropouts, goal
drop, Gumbel routing and the camera augmentations on); and the mesh
helpers against JAX's sharding rules (``Trainer.fit`` and
``training_calvin`` on 2 ranks: ``tests/test_torch_dp_trainer.py``). Tolerances are those of
``tests/test_torch_train_step.py`` (float64 against JAX under x64; f32 by
the floor rule: no further from float64 than twice JAX's own f32).
"""
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mode_diffusion_policy_tpu.models.modedit as jmodedit
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.parallel import mesh as jmesh
from mode_diffusion_policy_tpu.training import optim as jopt
from mode_diffusion_policy_tpu.training.loop import \
    make_train_step as jmake_step
from mode_diffusion_policy_tpu.training.state import TrainState as JState
from mode_diffusion_policy_tpu_torch.parallel import mesh as tmesh
from mode_diffusion_policy_tpu_torch.training_common import DEFAULT_PIPELINES
from mode_diffusion_policy_tpu_torch.utils.weights import port_tree
from torch_dp_worker import World
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(latent_dim=64, n_layers=2, n_heads=4, cond_dim=8,
            resnet_type="18", num_experts=4, top_k=2)
NO_DROP = dict(attn_pdrop=0.0, mlp_pdrop=0.0, goal_drop=0.0, embed_pdrob=0.0)
LOSS_KW = dict(entropy_gamma=0.01, router_z_delta=0.001, encoder_remat=False)
DROP = dict(attn_pdrop=0.3, mlp_pdrop=0.1, goal_drop=0.1, embed_pdrob=0.1)
OPT_KW = dict(learning_rate=3e-3, total_steps=100)
B, IMG, T_TOK, STEPS = 8, 32, 14, 3
# the camera pipelines at 32 px with colour jitter and random erasing on
# the static camera, and the word dropout
PIPELINES = {k: dict(v, size=IMG) for k, v in DEFAULT_PIPELINES.items()}
PIPELINES["rgb_static"] = dict(
    PIPELINES["rgb_static"],
    jitter={"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
            "hue": 0.1},
    erasing={"p": 0.5, "scale": (0.02, 0.33), "ratio": (0.3, 3.3),
             "value": 0.0})
PIPELINES["word_dropout_p"] = 0.2


def _random_variables(agent, seed=0):
    """f32 numpy weights and statistics (tests/test_torch_train_step.py's
    rule)."""
    shapes = jax.eval_shape(
        lambda k: agent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        key = jax.tree_util.keystr(path)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "var":
            out = r.uniform(0.5, 1.5, s.shape)
        elif name in ("g", "scale"):
            out = 1.0 + 0.1 * v
        elif name in ("mean", "bias"):
            out = 0.05 * v
        elif name == "kernel" and len(s.shape) == 4:
            out = v / np.sqrt(np.prod(s.shape[:3]))
        elif "router" in key:
            out = 0.5 * v
        else:
            out = 0.05 * v
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


def _batch(seed=3):
    r = np.random.default_rng(seed)
    return dict(
        rgb_static=r.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32),
        rgb_gripper=r.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32),
        actions=(r.standard_normal((B, 10, 7)) * 0.3).astype(np.float32),
        lang_emb=r.standard_normal((B, 1, 8)).astype(np.float32))


def _raw_batches(n=3, seed=5):
    """uint8 frames (resized 40 -> 32 px and augmented in the step)."""
    r = np.random.default_rng(seed)
    return [{"rgb_static": r.integers(0, 256, (B, 1, 40, 40, 3), np.uint8),
             "rgb_gripper": r.integers(0, 256, (B, 1, 40, 40, 3), np.uint8),
             "actions": (r.standard_normal((B, 10, 7)) * 0.3).astype(
                 np.float32),
             "lang_emb": r.standard_normal((B, 1, 8)).astype(np.float32)}
            for _ in range(n)]


def _draws():
    r = np.random.default_rng(21)
    return {"sigma": np.exp(r.standard_normal(B)).astype(np.float32),
            "noise": r.standard_normal((B, 10, 7)).astype(np.float32),
            "gumbel": [r.gumbel(size=(B, T_TOK, 4)).astype(np.float32)
                       for _ in range(DIMS["n_layers"])]}


def _patch_jax_draws(mp, d):
    """The JAX loss's draws made constants: the Gumbel top-k adds layer i's
    ``gumbel[i]``, the normal draw of the actions' shape is ``noise``."""
    calls = []

    def gumbel_topk(key, log_probs, k):
        g = d["gumbel"][len(calls) % DIMS["n_layers"]]
        calls.append(1)
        return jax.lax.top_k(log_probs + jnp.asarray(g, log_probs.dtype), k)[1]

    normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=None):
        if tuple(shape) == (B, 10, 7):
            return jnp.asarray(d["noise"], dtype or jnp.float32)
        return normal(key, shape, dtype or jnp.float32)

    mp.setattr(jmodedit, "gumbel_topk_sample", gumbel_topk)
    mp.setattr(jax.random, "normal", fake_normal)


def _np(tree):
    return {k: t.double().numpy()
            for k, t in port_tree(jax.tree.map(np.asarray, tree)).items()}


def _same(a, b):
    """Two ranks' digests of the same tensors agree."""
    assert set(a) == set(b)
    for n in a:
        assert a[n] == b[n], n


def _jax_agent(dtype, d):
    agent = JAgent(JCfg(dtype=dtype, **DIMS, **NO_DROP, **LOSS_KW))
    agent.sample_density = lambda k, s: jnp.asarray(d["sigma"], dtype)
    return agent


def _jax_loss_and_grads(v, batch, d, dtype):
    """JAX's loss, metrics, statistics update and gradient over the global
    batch."""
    agent = _jax_agent(dtype, d)
    vv = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)

    def lf(params):
        return agent.training_loss(
            {"params": params, "batch_stats": vv["batch_stats"]},
            jax.tree.map(lambda a: jnp.asarray(a, dtype), batch),
            jax.random.PRNGKey(5))

    (loss, (m, bs)), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        vv["params"])
    return {"loss": float(loss),
            "lb": float(m["train/load_balancing_loss"]),
            "expert_counts": np.asarray(m["expert_counts"]),
            "batch_stats": _np(bs), "grads": _np(g)}


def _jax_train(v, batch, d, dtype):
    """JAX's train step on a 2-device mesh, the batch sharded over ``dp``:
    the parameters after step 1 and after step STEPS."""
    agent = _jax_agent(dtype, d)
    vv = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)
    opt, _ = jopt.make_optimizer(vv["params"], **OPT_KW)
    mesh = jmesh.make_mesh(jax.devices()[:2])
    state = jmesh.replicate(mesh, JState.create(vv, opt,
                                                jax.random.PRNGKey(1)))
    jb = jmesh.shard_batch(mesh, jax.tree.map(
        lambda a: jnp.asarray(a, dtype), batch))
    step = jax.jit(jmake_step(agent, opt, log_grad_norms=False))
    out = {}
    for i in range(STEPS):
        state, _ = step(state, jb)
        if i + 1 in (1, STEPS):
            out[i + 1] = _np(state.params)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank world's results (rank 0's and rank 1's) and the JAX
    references, computed while the ranks run; the run directory is
    removed at the end."""
    tmp = tmp_path_factory.mktemp("dp")
    v = _random_variables(JAgent(JCfg(**DIMS)))
    batch, d = _batch(), _draws()
    torch.save({
        "variables": v, "cfg": dict(**DIMS, **NO_DROP, **LOSS_KW),
        "batch": batch, "draws": d, "opt_kw": OPT_KW, "drop_cfg": DROP,
        "raw_batches": _raw_batches(), "pipelines": PIPELINES},
        tmp / "inputs.pt")
    ranks = World("data_parallel", tmp)
    mp = pytest.MonkeyPatch()
    _patch_jax_draws(mp, d)
    try:
        ref = {"f32": _jax_loss_and_grads(v, batch, d, jnp.float32)}
        ref["steps32"] = _jax_train(v, batch, d, jnp.float32)
        with jax.enable_x64():
            ref["f64"] = _jax_loss_and_grads(v, batch, d, jnp.float64)
            ref["steps64"] = _jax_train(v, batch, d, jnp.float64)
    except BaseException:
        ranks.stop()
        raise
    finally:
        mp.undo()
    yield v, ref, ranks.results(timeout=240.0)
    shutil.rmtree(tmp, ignore_errors=True)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _maxrel(a, b, scale):
    return float(np.abs(a - b).max() / scale)


def _part_rel(got, want, dit):
    names = [n for n in want if n.startswith("inner_model.") == dit]
    num = sum(np.linalg.norm(got[n] - want[n]) ** 2 for n in names)
    return (num / sum(np.linalg.norm(want[n]) ** 2 for n in names)) ** 0.5


def test_world_and_ranks_agree(world):
    """Each rank sees a gloo world of 2 (``init_distributed`` from the
    torchrun variables), and the ranks' losses, reduced gradients,
    running statistics and parameters after 1 and 3 steps are
    bit-equal."""
    _, _, ranks = world
    assert [r["mesh"] for r in ranks] == [(2, 0, 0, 2, "gloo"),
                                          (2, 1, 1, 2, "gloo")]
    for kind in ("f64", "f32"):
        a, b = (r[kind] for r in ranks)
        assert a["loss"] == b["loss"] and a["lb"] == b["lb"]
        for what in ("grads", "batch_stats", 1, STEPS):
            _same(a["digest"][what], b["digest"][what])


def test_loss_grads_and_statistics_f64_are_jax_x64(world):
    """In float64 the 2-rank loss and every reduced gradient leaf are
    JAX's over the global batch within 1e-5 (relative; L2 for a leaf,
    leaves zero to rounding within 1e-12 absolute: JAX keeps a few f32
    casts in the DiT under x64, its loss here 14 f32 ulps from the
    port's), the running statistics within f32 rounding (flax keeps them
    f32 under x64), the expert counts (summed over the ranks) equal."""
    _, ref, ranks = world
    j, p = ref["f64"], ranks[0]["f64"]
    print(f"float64 loss: 2 ranks {p['loss'][0]:.12f}, JAX x64 "
          f"{j['loss']:.12f}")
    assert _rel(p["loss"][0], j["loss"]) <= 1e-5
    assert set(p["grads"]) == set(j["grads"])
    top = max(np.linalg.norm(g) for g in j["grads"].values())
    for n, g in j["grads"].items():
        nrm = np.linalg.norm(g)
        if nrm < 1e-9 * top:
            assert np.abs(p["grads"][n] - g).max() <= 1e-12, n
        else:
            assert np.linalg.norm(p["grads"][n] - g) / nrm <= 1e-5, n
    for n, s in j["batch_stats"].items():
        np.testing.assert_allclose(p["batch_stats"][n], s, rtol=2 ** -23,
                                   atol=0, err_msg=n)
    for r in ranks:
        np.testing.assert_array_equal(r["f64"]["expert_counts"],
                                      j["expert_counts"])
    assert p["expert_counts"].sum() == B * T_TOK * 2 * DIMS["n_layers"]


def test_loss_grads_and_statistics_f32_match_jax(world):
    """f32: the loss within 2e-5 relative or the floor rule; each gradient
    leaf within atol 1e-5 / rtol 1e-4 of JAX's f32 or at most 4x JAX's own
    f32 error from float64, and 2x over all such leaves; the running
    statistics within 2e-5 or the floor rule."""
    _, ref, ranks = world
    j, j64, p = ref["f32"], ref["f64"], ranks[0]["f32"]
    assert _rel(p["loss"][0], j["loss"]) <= max(
        2e-5, 2 * _rel(j["loss"], j64["loss"]))
    port_err = jax_err = 0.0
    for n, g in j["grads"].items():
        pg, g64 = p["grads"][n], j64["grads"][n]
        if np.all(np.abs(pg - g) <= 1e-5 + 1e-4 * np.abs(g)):
            continue
        pe, je = np.linalg.norm(pg - g64), np.linalg.norm(g - g64)
        assert pe <= 4 * je, (n, pe, je)
        port_err, jax_err = port_err + pe ** 2, jax_err + je ** 2
    assert port_err <= 4 * jax_err, (port_err, jax_err)
    for n, s in j["batch_stats"].items():
        sc = np.abs(j64["batch_stats"][n]).max()
        assert _maxrel(p["batch_stats"][n], s, sc) <= max(
            2e-5, 2 * _maxrel(s, j64["batch_stats"][n], sc)), n


def test_load_balancing_term_is_global(world):
    """The 2-rank load-balancing term is JAX's over the global batch
    (float64, within 1e-6), and the mean of the terms each rank computes
    on its own rows is not (it differs by more than that tolerance): the
    reduction of both means before their product is what makes it
    global."""
    _, ref, ranks = world
    want = ref["f64"]["lb"]
    got = ranks[0]["f64"]["lb"]
    local = float(np.mean([r["local_lb"] for r in ranks]))
    print(f"load-balancing term: JAX global {want:.12f}, 2 ranks "
          f"{got:.12f}, mean of the ranks' own terms {local:.12f} "
          f"(relative {_rel(local, want):.2e})")
    assert _rel(got, want) <= 1e-6
    assert _rel(local, want) > 1e-6


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_jax(world, steps):
    """The parameters' update after 1 and 3 steps against JAX's float64
    step over the global batch on its 2-device mesh (relative L2 over the
    DiT's leaves and over the encoders'): the 2-rank float64 run at most
    half as far as JAX's own f32 step, the 2-rank f32 run at most twice
    as far (tests/test_torch_train_step.py's rules)."""
    v, ref, ranks = world
    p0 = _np(v["params"])
    want = {n: x - p0[n] for n, x in ref["steps64"][steps].items()}
    runs = {"jax_f32": {n: x - p0[n]
                        for n, x in ref["steps32"][steps].items()},
            "port_f64": ranks[0]["f64"]["update"][steps],
            "port_f32": ranks[0]["f32"]["update"][steps]}
    for dit in (True, False):
        dist = {k: _part_rel(x, want, dit) for k, x in runs.items()}
        print(f"after {steps} step(s), {'DiT' if dit else 'encoders'}: "
              + ", ".join(f"{k} {x:.2e}" for k, x in dist.items()))
        assert dist["port_f64"] <= 0.5 * dist["jax_f32"], (dit, dist)
        assert dist["port_f32"] <= 2 * dist["jax_f32"], (dit, dist)


def test_remat_under_two_ranks_updates_statistics_once(world):
    """encoder_remat on 2 ranks (the f32 run): the rematerialized forward
    issues its reductions again in the backward pass without a hang, and
    each running statistic moved once: within 2e-5 (relative to its
    largest value) of JAX's one update, and further than that from a
    second update (flax's ``0.9 * s + 0.1 * batch``: ``1.9 * s1 - 0.9 *
    s0``)."""
    v, ref, ranks = world
    s0, s1 = _np(v["batch_stats"]), ref["f64"]["batch_stats"]
    got = ranks[0]["f32"]["batch_stats"]
    assert set(got) == set(s1) and len(s1) > 0
    once = twice = 0.0
    for n, s in s1.items():
        sc = np.abs(s).max()
        once = max(once, _maxrel(got[n], s, sc))
        twice = max(twice, _maxrel(got[n], 1.9 * s - 0.9 * s0[n], sc))
    print(f"remat running statistics: {once:.2e} from one update, "
          f"{twice:.2e} from two")
    assert once <= 2e-5 < twice, (once, twice)


@pytest.mark.parametrize("case,steps", [("invariance", 3),
                                        ("invariance_grouped", 1)],
                         ids=["dense_moe", "grouped_moe"])
def test_two_ranks_draw_what_one_rank_draws(world, case, steps):
    """Dropouts, goal drop, Gumbel routing and the camera augmentations
    on, from uint8 frames: after each step (3 with the dense MoE, 1 with
    ``use_grouped_moe``, whose expert dropout covers the expert-sorted
    pairs) the 2-rank generator state equals the 1-rank run's at the same
    global batch, and the parameters' update lies within 1e-3 (relative
    L2) of it on the DiT and on the encoders, the rounding of the
    reductions apart."""
    _, _, ranks = world
    inv = ranks[0][case]
    assert inv["rng_equal"] == [True] * steps
    print(f"{case}: 2 ranks vs 1 rank, relative L2 of the update: "
          f"{inv['distance']}")
    for part, d in inv["distance"].items():
        assert d <= 1e-3, (part, d)
    _same(inv["digest"], ranks[1][case]["digest"])


def test_mesh_helpers_follow_jax_sharding():
    """Without a process group ``make_mesh`` is a world of 1 on the
    caller's device. A batch shards over ranks only where it divides, as
    JAX's batch sharding over ``dp`` devices; the per-rank batch is the
    host's batch over its local ranks; ``global_batch_size`` multiplies
    by the world."""
    one = tmesh.make_mesh("cpu")
    assert (one.size, one.rank, one.device.type, one.backend) == \
        (1, 0, "cpu", None)
    two = tmesh.Mesh(size=2, rank=1, local_rank=1, local_size=2)
    four = tmesh.Mesh(size=4, rank=0, local_size=4)
    assert tmesh.batch_sharding(two, 8) == slice(4, 8)
    assert tmesh.global_batch_size(16, two) == 32
    assert tmesh.per_rank_batch(128, four) == 32
    jm = jmesh.make_mesh(jax.devices()[:4])
    for rows in (6, 8):
        x = {"a": np.zeros((rows, 3), np.float32)}
        try:
            jmesh.shard_batch(jm, x)
            jax_ok = True
        except ValueError:
            jax_ok = False
        if jax_ok:
            assert tmesh.per_rank_batch(rows, four) == rows // 4
            assert len(tmesh.shard_batch(x, four)["a"]) == rows // 4
        else:
            with pytest.raises(ValueError):
                tmesh.per_rank_batch(rows, four)
            with pytest.raises(ValueError):
                tmesh.shard_batch(x, four)
    with pytest.raises(ValueError):
        tmesh.batch_sharding(two, 7)
    assert math.prod(jm.devices.shape) == 4
