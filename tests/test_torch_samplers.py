"""Every sampler of the JAX dispatch table against the port's, through
``sample_loop`` in both packages: the same analytic denoiser (EDM form,
built from the same numpy constants in both frameworks), the same initial
noise and, for the stochastic samplers, the same draws (JAX's key splits
replayed into the port's noise function), at the sweep's 4, 10 and 16 steps
(``conf/sweep.yaml``), sigma 80 -> 0.001 (the churned samplers: 40 -> 0.01,
the sweep's other ends).

Gate: the actions within atol 1e-5 in f32, and the same sequence of
``step_idx`` values (on the schedule the step, off it -1), since the step
index decides an agent's routing. The JAX samplers run op by op
(``jax.disable_jit``): inside a compiled ``lax.scan`` XLA contracts
multiply-adds into FMAs, which moves x by one ulp at the sigma-80 scale
(1e-5), and the 4-step heun / dpm / ancestral updates divide such
differences by sigma 0.001, 1.2e-4 at the end; op by op, each operation
rounds once on both sides and 42 of the 45 runs agree bit for bit
(dpm_adaptive within 6e-7: its error norm sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu_torch.models.edm import samplers as tsamplers
from mode_diffusion_policy_tpu_torch.models.edm.schedules import (
    get_noise_schedule)
from torch_threads import two_torch_threads  # noqa: F401

B, W, A = 2, 10, 7
r = np.random.default_rng(0)
SLOPE = (0.5 + 0.5 * r.random((W, A))).astype(np.float32)
SHIFT = (0.3 * r.standard_normal((W, A))).astype(np.float32)
X0 = r.standard_normal((B, W, A)).astype(np.float32)


def _scalings(s, sqrt):
    """c_skip, c_out of EDM with sigma_data 0.5, broadcast over [B,W,A]."""
    s = s[:, None, None]
    return 0.25 / (s * s + 0.25), s * 0.5 / sqrt(s * s + 0.25)


# The model part is a softsign of an elementwise affine map: only IEEE
# operations that both frameworks round exactly (no tanh or pow, whose
# approximations differ between XLA and PyTorch).
def _jax_denoiser(calls):
    def den(x, sigma, step_idx):
        jax.debug.callback(lambda i: calls.append(int(i)), step_idx,
                           ordered=True)
        c_skip, c_out = _scalings(sigma, jnp.sqrt)
        y = x * SLOPE + SHIFT
        return c_skip * x + c_out * (y / (1.0 + jnp.abs(y)))
    return den


def _torch_denoiser(calls):
    slope, shift = torch.from_numpy(SLOPE), torch.from_numpy(SHIFT)

    def den(x, sigma, step_idx):
        calls.append(int(step_idx))
        c_skip, c_out = _scalings(sigma, torch.sqrt)
        y = x * slope + shift
        return c_skip * x + c_out * (y / (1.0 + y.abs()))
    return den


class JaxNoise:
    """The port's noise function replaying a JAX sampler's draws: each
    step splits the key into (key, sub) and draws from sub, or, for the
    two draws of each ``dpmpp_2m_sde`` step, into (key, k1, k2)."""

    def __init__(self, key, per_split=1):
        self.key, self.per_split, self.subs = key, per_split, []

    def __call__(self, x):
        if not self.subs:
            self.key, *self.subs = jax.random.split(self.key,
                                                    1 + self.per_split)
        k = self.subs.pop(0)
        return torch.from_numpy(np.array(jax.random.normal(
            k, tuple(x.shape), jnp.float32)))


def _run(name, steps, sigma_min=0.001, sigma_max=80.0, extra=None, seed=3):
    sigmas = get_noise_schedule(steps, "exponential", sigma_min, sigma_max)
    x0 = X0 * sigma_max
    jcalls, tcalls = [], []
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        want = np.asarray(jsamplers.sample_loop(
            name, _jax_denoiser(jcalls), jnp.asarray(x0), sigmas, key,
            dict(extra or {})))
    jax.effects_barrier()
    noise = JaxNoise(key, 2 if name == "dpmpp_2m_sde" else 1)
    got = tsamplers.sample_loop(name, _torch_denoiser(tcalls),
                                torch.from_numpy(x0), sigmas,
                                extra_args=dict(extra or {}),
                                noise_fn=noise).numpy()
    return got, want, tcalls, jcalls


@pytest.mark.parametrize("steps", [4, 10, 16])
@pytest.mark.parametrize("name", sorted(jsamplers.SAMPLERS))
def test_sampler_matches_jax(name, steps):
    got, want, tcalls, jcalls = _run(name, steps)
    assert tcalls == jcalls, (tcalls, jcalls)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["euler", "heun", "dpm"])
def test_churned_samplers_go_off_schedule(name):
    """With s_churn > 0 every evaluation is at a churned sigma, so off the
    schedule (-1), and each step draws its churn noise."""
    got, want, tcalls, jcalls = _run(name, 10, sigma_min=0.01,
                                     sigma_max=40.0,
                                     extra={"s_churn": 1.0,
                                            "keep_last_actions": True})
    assert tcalls == jcalls and set(tcalls) == {-1}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_off_schedule_counts_of_the_sweep_samplers():
    """The evaluations per 10-step chunk of the sweep's samplers, on and off
    the schedule, that the kernel launch counts of chip_smoke.py rest on."""
    counts = {}
    for name in ("ddim", "dpmpp_2m", "euler", "heun", "dpmpp_2s_ancestral"):
        _, _, calls, _ = _run(name, 10)
        counts[name] = (sum(i >= 0 for i in calls), sum(i < 0 for i in calls))
    assert counts == {"ddim": (10, 0), "dpmpp_2m": (10, 0), "euler": (10, 0),
                      "heun": (19, 0), "dpmpp_2s_ancestral": (10, 9)}


def test_default_noise_comes_from_a_generator():
    """Without a noise function the stochastic samplers draw from the
    generator given (a new one seeded 0 when none is): the same seed, the
    same chunk."""
    sigmas = get_noise_schedule(4, "exponential", 0.001, 80.0)
    x0 = torch.from_numpy(X0 * 80.0)
    den = _torch_denoiser([])

    def run(gen=None):
        return tsamplers.sample_loop("dpmpp_2s_ancestral", den, x0, sigmas,
                                     gen)

    a = run(torch.Generator().manual_seed(5))
    b = run(torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(run(), run(torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)
    assert not torch.equal(a, run())


def test_unknown_sampler_raises():
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="not found"):
        tsamplers.sample_loop("no-such-sampler", lambda x, s, i: x, x,
                              np.array([1.0, 0.0]))
    assert set(tsamplers.SAMPLERS) == set(jsamplers.SAMPLERS)
