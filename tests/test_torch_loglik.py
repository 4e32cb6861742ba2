"""``log_likelihood`` and its integrator against the JAX package, and the
guard that keeps the CUDA kernels out of autodiff.

- The port's Dormand-Prince ``odeint`` against
  ``jax.experimental.ode.odeint`` on closed-form ODEs (a damped linear
  rotation and the stiff-ish scalar y' = -50 (y - t)), each over
  [0, 0.7, 3.0], in float64 at three rtol/atol pairs and in f32 at two:
  the same count of accepted and rejected steps (JAX's read from the times
  at which it evaluates the ODE: a rejected step restarts from the same t),
  the same number of evaluations, and the values within 1e-6 relative.
  The f32 pairs stop at rtol 1e-4: the two sides' step sizes differ in the
  last bit (XLA's f32 ``pow`` against the C library's, in the step-size
  rule), and from rtol 1e-5 down that moves the result by the order of the
  tolerance itself (7.8e-6 relative on the stiff ODE at rtol 1e-5, with the
  same accepted and rejected steps); in float64 the values agree to 1e-14.
- ``log_likelihood`` of the port against JAX's on an agent denoiser at
  embed 64, 2 layers, 4 heads (the JAX parity tests' DiT), B=2, the same
  weights (``utils/weights.from_jax_params``) and JAX's own Rademacher draw
  passed in as ``v``: the same accepted and rejected steps, then the values
  within max(1e-4, 2 x floor) relative, the floor being the port's own f32
  result's distance from its float64 run (the rule ``chip_smoke.py``
  holds kernels to). The floor is real: the ODE's slope ``(x - D(x)) /
  sigma`` and its JVP cancel at sigma 1e-3, and in f32 the two packages'
  results sit 2.0e-4 (port) and 6.6e-5 (JAX) relative from the float64
  integral, in different directions; the float64 run is within 1e-4 of
  JAX's. The f32-vs-f64 gap printed here is what phase 26a's gate on the
  card is derived from (PERF.md).
- ``ops/kernels/_common.autodiff_reason``: a ``torch.func`` transform, a
  forward-mode dual tensor and a grad-requiring input under grad mode are
  caught, plain tensors and ``no_grad`` are not; every kernel wrapper
  refuses such inputs before it launches (checked with meta tensors: the
  guard comes before the device check, the CPU tensors' plain versions
  stay differentiable).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.ode import odeint as jax_odeint

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgent
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.edm import log_likelihood
from mode_diffusion_policy_tpu_torch.models.edm.samplers import odeint
from mode_diffusion_policy_tpu_torch.ops.kernels import (attn_kernel,
                                                         layer_kernel,
                                                         moe_kernel)
from mode_diffusion_policy_tpu_torch.ops.kernels._common import \
    autodiff_reason
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from torch_threads import two_torch_threads  # noqa: F401


A_LIN = np.array([[-0.5, 1.0], [-1.0, -0.2]])
TS = [0.0, 0.7, 3.0]


def _ode(name, xp):
    if name == "linear":
        return (lambda y, t: xp.asarray(A_LIN, dtype=y.dtype) @ y,
                np.array([1.0, 0.5]))
    return lambda y, t: -50.0 * (y - t), np.array([1.0])


def _jax_steps(times):
    """(accepted, rejected) steps of a JAX odeint run from the times of its
    evaluations: two for the initial step size, then six per step at
    t + dt * (1/5, 3/10, 4/5, 8/9, 1, 1); a rejected step's successor
    starts at the same t, an accepted one's at t + dt."""
    T = np.asarray(times[2:], np.float64).reshape(-1, 6)
    dt = (T[:, 4] - T[:, 0]) / 0.8
    t = T[:, 4] - dt
    moved = np.abs(np.diff(t)) > 0.5 * dt[:-1]
    accepted = int(moved.sum()) + 1       # the last step is accepted
    return accepted, len(t) - accepted


CASES = [(dt, name, rtol, atol)
         for dt, tols in (("f64", [(1e-6, 1e-9), (1e-8, 1e-10),
                                   (1e-10, 1e-12)]),
                          ("f32", [(1e-3, 1e-6), (1e-4, 1e-4)]))
         for name in ("linear", "stiff") for rtol, atol in tols]


@pytest.mark.parametrize("dt,name,rtol,atol", CASES)
def test_dopri5_matches_jax_odeint(dt, name, rtol, atol):
    np_dt = np.float64 if dt == "f64" else np.float32
    ts = np.asarray(TS, np_dt)
    jtimes = []
    with jax.enable_x64(dt == "f64"):
        jf, y0 = _ode(name, jnp)

        def f(y, t):
            jax.debug.callback(lambda tt: jtimes.append(float(tt)), t,
                               ordered=True)
            return jf(y, t)

        want = np.asarray(jax_odeint(f, jnp.asarray(y0.astype(np_dt)),
                                     jnp.asarray(ts), rtol=rtol, atol=atol))
        jax.effects_barrier()
    tf, _ = _ode(name, torch)
    stats = {}
    got = odeint(tf, torch.from_numpy(y0.astype(np_dt)), ts, rtol=rtol,
                 atol=atol, stats=stats).numpy()
    assert got.dtype == np_dt and got.shape == want.shape == (3, len(y0))
    assert stats["evaluations"] == len(jtimes)
    assert (stats["accepted"], stats["rejected"]) == _jax_steps(jtimes)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_odeint_dense_output_and_limits():
    """The dense output at an intermediate time is the closed form within
    the tolerance; ``mxstep`` bounds the steps per output time and ``hmax``
    the step size."""
    f = lambda y, t: -y                                  # noqa: E731
    y0 = torch.tensor([1.0], dtype=torch.float64)
    ys = odeint(f, y0, [0.0, 0.3, 1.0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ys[:, 0].numpy(), np.exp([0.0, -0.3, -1.0]),
                               rtol=1e-8)
    st = {}
    odeint(f, y0, [0.0, 1.0], rtol=1e-9, atol=1e-12, mxstep=3, stats=st)
    assert st["accepted"] + st["rejected"] == 3
    st = {}
    odeint(f, y0, [0.0, 1.0], hmax=0.05, stats=st)
    assert st["accepted"] >= 20


# -- log_likelihood on an agent denoiser --------------------------------------

DIMS = dict(latent_dim=64, n_layers=2, n_heads=4, cond_dim=16, num_experts=4,
            top_k=2, resnet_type="18")
B = 2


def _random_variables(agent, seed=0):
    shapes = jax.eval_shape(
        lambda k: agent.init_variables(k, image_hw=(32, 32)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("g", "scale"):
            return 1.0 + 0.1 * v
        if name in ("mean", "bias"):
            return 0.05 * v
        if name == "kernel" and len(s.shape) == 4:
            return v / np.sqrt(np.prod(s.shape[:3]))
        if "router" in jax.tree_util.keystr(path):
            return 0.5 * v
        return 0.05 * v

    return jax.tree_util.tree_map_with_path(
        fill, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


@pytest.fixture(scope="module")
def loglik():
    """JAX's and the port's log-likelihood of the same samples under the
    same denoiser (weights, perceptual embedding, goal) and Rademacher
    draw; the port's f32 and float64 runs with their step counts."""
    jagent = JAgent(JCfg(**DIMS))
    v = _random_variables(jagent)
    r = np.random.default_rng(1)
    emb = r.standard_normal((B, 2, jagent.cfg.obs_dim)).astype(np.float32)
    goal = r.standard_normal((B, 1, DIMS["cond_dim"])).astype(np.float32)
    x = r.standard_normal((B, 10, 7)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jden = jagent.make_denoiser(v, {"state_images": jnp.asarray(emb)},
                                jnp.asarray(goal))
    jtimes = []

    def counted(xx, sigma, step_idx):
        jax.debug.callback(lambda s: jtimes.append(float(s)), sigma[0],
                           ordered=True)
        return jden(xx, sigma, step_idx)

    want = np.asarray(jsamplers.log_likelihood(
        counted, jnp.asarray(x), jagent.cfg.sigma_min, jagent.cfg.sigma_max,
        key))
    jax.effects_barrier()
    # JAX's own draw: randint(key, shape, 0, 2) * 2 - 1
    rad = np.asarray(jax.random.randint(key, x.shape, 0, 2)
                     .astype(jnp.float32)) * 2 - 1
    numpy_v = jax.tree.map(np.asarray, v)
    out = {"want": want, "jax_steps": _jax_steps(jtimes)}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        agent = from_jax_params(numpy_v, TCfg(dtype=dt, **DIMS),
                                device="cpu").to(dt)
        den = agent.make_denoiser(
            {"state_images": torch.from_numpy(emb).to(dt)},
            torch.from_numpy(goal).to(dt))
        stats = {}
        got = log_likelihood(den, torch.from_numpy(x).to(dt),
                             agent.cfg.sigma_min, agent.cfg.sigma_max,
                             v=torch.from_numpy(rad), stats=stats)
        out[name] = (got.detach().numpy(), stats)
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_log_likelihood_matches_jax(loglik):
    got, stats = loglik["f32"]
    want = loglik["want"]
    assert got.shape == want.shape == (B,) and np.isfinite(got).all()
    # the same accept/reject sequence, then the values
    assert (stats["accepted"], stats["rejected"]) == loglik["jax_steps"]
    floor = _rel(got, loglik["f64"][0])
    tol = max(1e-4, 2 * floor)
    print(f"port vs JAX {_rel(got, want):.3e} relative (tol {tol:.3e}, "
          f"floor {floor:.3e})")
    assert _rel(got, want) <= tol


def test_log_likelihood_f32_vs_f64(loglik):
    """The f32-vs-f64 gap of the port at this size (printed; phase 26a's
    gate on the card is derived from it), the same steps in both, and the
    float64 run within 1e-4 of JAX's f32 result."""
    (g32, s32), (g64, s64) = loglik["f32"], loglik["f64"]
    gap = _rel(g32, g64)
    print(f"f32 vs f64: max relative gap {gap:.3e}; steps {s32} / {s64}")
    assert s32 == s64 and gap < 1e-3
    assert _rel(g64, loglik["want"]) <= 1e-4


def test_log_likelihood_draws_v_from_generator():
    """Without ``v`` the Rademacher draw comes from the generator: the
    same seed gives the same result, +-1 entries only."""
    agent = MoDEAgent(TCfg(latent_dim=64, n_layers=1, n_heads=4,
                           cond_dim=16, resnet_type="18"), device="cpu")
    emb = {"state_images": torch.randn(1, 2, agent.cfg.obs_dim)}
    den = agent.make_denoiser(emb, torch.randn(1, 1, 16))
    x = torch.randn(1, 10, 7)
    a = log_likelihood(den, x, 0.001, 80.0,
                       torch.Generator().manual_seed(5), rtol=1e-3,
                       atol=1e-3)
    b = log_likelihood(den, x, 0.001, 80.0,
                       torch.Generator().manual_seed(5), rtol=1e-3,
                       atol=1e-3)
    assert torch.equal(a, b) and torch.isfinite(a).all()


# -- the autodiff guard of the kernel wrappers ---------------------------------

def test_autodiff_reason_predicate():
    x = torch.randn(3)
    assert autodiff_reason(x, (x, None), {"w": x}) is None
    w = torch.randn(3, requires_grad=True)
    assert "requires grad" in autodiff_reason(x, (w,))
    with torch.no_grad():
        assert autodiff_reason(x, w) is None
    with torch.autograd.forward_ad.dual_level():
        d = torch.autograd.forward_ad.make_dual(x, torch.ones(3))
        assert "dual" in autodiff_reason(x, {"stack": d})
        assert autodiff_reason(x) is None

    seen = []

    def f(a):
        seen.append(autodiff_reason(a))
        return a * 2

    torch.func.jvp(f, (x,), (torch.ones(3),))
    torch.func.vmap(f)(x[None])
    assert all("torch.func" in s for s in seen) and len(seen) == 2


WRAPPERS = {
    "fused_attn_block": lambda t: attn_kernel.fused_attn_block(
        t, t, t, t, t, t, t, t),
    "fused_attn_block_q8": lambda t: attn_kernel.fused_attn_block_q8(
        t, t, t, (t,), t, t),
    "fused_top2_mlp": lambda t: moe_kernel.fused_top2_mlp(t, t, t, t, t, t),
    "fused_top2_mlp_q8": lambda t: moe_kernel.fused_top2_mlp_q8(
        t, t, t, (t,)),
    "fused_top2_mlp_q8c": lambda t: moe_kernel.fused_top2_mlp_q8c(
        t, t, t, (t,)),
    "fused_layer_q8c": lambda t: layer_kernel.fused_layer_q8c(
        t, t, t, t, t, t, t, t, t, (t,), t, t),
    "fused_dit_q8c": lambda t: layer_kernel.fused_dit_q8c(
        t, t, {"w": t}, t, t),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrappers_refuse_autodiff(name):
    """Off the CPU a wrapper checks for autodiff before anything else: a
    grad-requiring input, a dual tensor and a torch.func transform raise
    its RuntimeError (meta tensors stand in for CUDA ones here), while the
    same plain input reaches the device check."""
    call = WRAPPERS[name]
    x = torch.zeros(1, 2, 128, device="meta")
    with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no "
                                           "derivative.*requires grad"):
        call(x.requires_grad_())
    x = torch.zeros(1, 2, 128, device="meta")
    with torch.autograd.forward_ad.dual_level():
        d = torch.autograd.forward_ad.make_dual(x, torch.zeros_like(x))
        with pytest.raises(RuntimeError, match="dual tensor"):
            call(d)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call(x)
