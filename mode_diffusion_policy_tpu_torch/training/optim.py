"""Optimizers, learning-rate and EMA schedules (counterpart of
``mode_diffusion_policy_tpu/training/optim.py``).

- ``tri_stage_schedule``: warmup -> hold -> cosine decay, in float32 host
  arithmetic that follows the JAX schedule's casts step for step.
- ``FusedAdamWEma``: AdamW (+ optional global-norm clip) + masked weight
  decay + LR schedule + parameter update + EMA in one pass over the
  parameters, with the JAX class's numerics (the bf16 ``mu_dtype``
  promotion order, f32 bias-correction scalars, stochastic-rounded bf16
  parameters). The parameters, moments and EMA live in one flat buffer per
  (dtype, decay flag) group (``FlatLayout``; the agent's parameters become
  views into theirs), so the update is a few elementwise passes over a
  few buffers instead of a dozen launches per leaf. JAX fuses it into one
  XLA loop per leaf; there is no Pallas kernel to port here.
- ``make_optimizer``: the fused optimizer, or (``fused=False``) the same
  math as a chain of transforms, the counterpart of the optax chain
  (``scale_by_adam`` -> ``add_decayed_weights`` ->
  ``scale_by_learning_rate``, ``apply_updates``, ``ema_update``), and
  ``adopt``.
- ``stochastic_round_bf16``: the f32 -> bf16 write-back of the bf16
  training state, on an int32 view of the f32 bits.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

F32 = np.float32
# elements per pass of the flat update: bounds its temporaries
CHUNK = 1 << 25


def tri_stage_schedule(peak_lr: float, total_steps: int,
                       phase_ratio: Tuple[float, float, float] = (0.02, 0.08,
                                                                  0.9),
                       init_lr_scale: float = 0.1,
                       final_lr_scale: float = 1e-6) -> Callable:
    """``schedule(step) -> float32 lr``: linear warmup from
    ``init_lr_scale * peak`` to ``peak``, hold, cosine decay to
    ``final_lr_scale * peak``, then constant (the reference
    TriStageLRScheduler)."""
    warmup_steps = int(total_steps * phase_ratio[0])
    hold_steps = int(total_steps * phase_ratio[1])
    decay_steps = int(total_steps * phase_ratio[2])
    init_lr = init_lr_scale * peak_lr
    final_lr = final_lr_scale * peak_lr
    warmup_rate = (peak_lr - init_lr) / warmup_steps if warmup_steps else 0.0
    half_span = F32(0.5 * (peak_lr - final_lr))

    def schedule(step) -> np.float32:
        step = F32(step)
        if step < warmup_steps:
            return F32(init_lr) + F32(warmup_rate) * step
        if step < warmup_steps + hold_steps:
            return F32(peak_lr)
        if step <= warmup_steps + hold_steps + decay_steps:
            decay_t = (step - F32(warmup_steps) - F32(hold_steps)) \
                / F32(max(decay_steps, 1))
            # cos of the f32 argument, correctly rounded to f32 (JAX's own
            # eager and compiled schedules differ in these last bits)
            cos = F32(math.cos(float(decay_t * F32(math.pi))))
            return F32(final_lr) + half_span * (F32(1.0) + cos)
        return F32(final_lr)

    return schedule


def constant_schedule(lr: float) -> Callable:
    return lambda step: F32(lr)


def ema_decay_schedule(step, *, inv_gamma: float = 1.0,
                       power: float = 2 / 3, min_value: float = 0.0,
                       max_value: float = 0.9999,
                       start_step: int = 0) -> np.float32:
    """NVIDIA-style EMA warmup decay ``1 - (1 + step/inv_gamma)^-power``,
    clamped, in float32."""
    step = F32(max(0, int(step) - start_step - 1))
    value = F32(1.0) - (F32(1.0) + step / F32(inv_gamma)) ** F32(-power)
    return F32(min(max(value, F32(min_value)), F32(max_value)))


def decay_mask(names) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name: the DiT
    (``inner_model.*``) excludes only leaves named ``bias``; every encoder
    leaf decays. The port's names end in the JAX leaf names, so every
    leaf gets the JAX ``_decay_mask`` flag."""
    out = {}
    for n in names:
        parts = n.split(".")
        out[n] = parts[-1] != "bias" if parts[0] == "inner_model" else True
    return out


def stochastic_round_bf16(x32: torch.Tensor, generator=None,
                          noise: str = "hw",
                          bits: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Round f32 -> bf16 stochastically (E[round(x)] = x): add 16 uniform
    random bits to the low half of the f32 bit pattern and truncate; inf
    and NaN pass through. The bits are ``bits`` (int32 in [0, 65535]) or
    drawn from ``generator``: 16 bits each for the noise sources "hw" and
    "threefry", one byte times 257 for "threefry8" (the JAX sources'
    distributions; JAX's hardware stream itself has no counterpart here).
    Works on an int32 view of the bits, where the addition wraps as the
    JAX uint32 addition does."""
    x32 = x32.float()
    if bits is None:
        bits = draw_sr_bits(x32.shape, generator, noise, x32.device)
    raw = x32.view(torch.int32)
    rounded = torch.where(torch.isfinite(x32), raw + bits.to(torch.int32),
                          raw)
    return (rounded & -65536).view(torch.float32).to(torch.bfloat16)


def draw_sr_bits(shape, generator, noise: str = "hw", device=None):
    if noise == "threefry8":
        return torch.randint(0, 256, tuple(shape), generator=generator,
                             device=device, dtype=torch.int32) * 257
    if noise not in ("hw", "threefry"):
        raise ValueError(f"unknown stochastic-rounding noise {noise!r}")
    return torch.randint(0, 65536, tuple(shape), generator=generator,
                         device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# flat parameter groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Group:
    dtype: torch.dtype
    decay: bool
    names: List[str]
    shapes: List[torch.Size]
    offsets: List[int]
    numel: int


class FlatLayout:
    """Parameters grouped by (dtype, decay flag), in name order within a
    group; each group is one flat buffer, each leaf a view into it."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 mask: Mapping[str, bool]):
        keyed: Dict[Tuple[torch.dtype, bool], List[str]] = {}
        for n, p in params.items():
            keyed.setdefault((p.dtype, bool(mask[n])), []).append(n)
        self.groups: List[Group] = []
        for (dt, dec), names in keyed.items():
            shapes = [params[n].shape for n in names]
            offs = np.cumsum([0] + [s.numel() for s in shapes]).tolist()
            self.groups.append(Group(dt, dec, names, shapes, offs[:-1],
                                     offs[-1]))
        self.names = [n for g in self.groups for n in g.names]

    def views(self, flats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for g, f in zip(self.groups, flats):
            for n, s, o in zip(g.names, g.shapes, g.offsets):
                out[n] = f[o:o + s.numel()].view(s)
        return out

    def new(self, device, dtype_of: Callable[[Group], torch.dtype],
            init: Optional[Mapping[str, torch.Tensor]] = None) -> "FlatDict":
        """A FlatDict of zeros (or a copy of ``init``), each group in
        ``dtype_of(group)``."""
        flats = [torch.zeros(g.numel, dtype=dtype_of(g), device=device)
                 for g in self.groups]
        fd = FlatDict(self, flats)
        if init is not None:
            with torch.no_grad():
                for n, v in fd.items():
                    v.copy_(init[n])
        return fd

    def flatten_params_(self, params: Mapping[str, torch.Tensor]
                        ) -> "FlatDict":
        """Move each parameter's data into its group's flat buffer and make
        it a view there (the parameters keep their identity); returns the
        FlatDict of the parameters themselves."""
        dev = next(iter(params.values())).device
        flats = [torch.empty(g.numel, dtype=g.dtype, device=dev)
                 for g in self.groups]
        views = self.views(flats)
        with torch.no_grad():
            for n, v in views.items():
                v.copy_(params[n])
                params[n].data = v
        return FlatDict(self, flats, {n: params[n] for n in self.names})


class FlatDict(collections.abc.Mapping):
    """Leaves by name over a FlatLayout's flat buffers (``flats``)."""

    def __init__(self, layout: FlatLayout, flats: List[torch.Tensor],
                 leaves: Optional[Dict[str, torch.Tensor]] = None):
        self.layout = layout
        self.flats = flats
        self._leaves = leaves if leaves is not None else layout.views(flats)

    def __getitem__(self, k):
        return self._leaves[k]

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self):
        return len(self._leaves)


def _flats_of(d: Mapping[str, torch.Tensor], layout: FlatLayout):
    """``d``'s flat buffers under ``layout``: its own when it is a FlatDict
    of that layout (no copy), else a flat copy (``copy_back`` then writes
    the results into ``d``'s tensors)."""
    if isinstance(d, FlatDict) and d.layout is layout:
        return d.flats, False
    return [torch.cat([d[n].reshape(-1) for n in g.names])
            for g in layout.groups], True


def _copy_back(d, layout, flats):
    with torch.no_grad():
        for n, v in layout.views(flats).items():
            d[n].copy_(v)


# ---------------------------------------------------------------------------
# fused AdamW + EMA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedAdamWEmaState:
    """``count`` (completed updates), first and second moments by name."""
    count: int
    mu: Mapping[str, torch.Tensor]
    nu: Mapping[str, torch.Tensor]


def _global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (optax
    ``global_norm``)."""
    return torch.sqrt(torch.stack([(g * g).sum().float()
                                   for g in grads.values()]).sum())


class FusedAdamWEma:
    """AdamW (+ optional global-norm clip) + masked weight decay + LR
    schedule + parameter update + EMA maintenance in one pass over flat
    parameter groups. Numerics follow the JAX ``FusedAdamWEma`` (and so
    ``optax.adamw`` + ``apply_updates`` + ``ema_update``): ``b1 * mu`` runs
    in mu's dtype (bf16 with ``mu_dtype=torch.bfloat16``) before the f32
    add, the bias corrections are f32 scalars, and each operation rounds
    on its own (separate multiply and add, no fused multiply-add).

    ``stochastic_round=True`` (the bf16 training state): the update math
    runs in f32 and bf16 parameters are written back by
    ``stochastic_round_bf16``, the noise drawn from the ``generator``
    passed to ``update_with_ema`` (``sr_noise`` names the JAX source whose
    distribution it follows). ``last_lr`` is the LR of the last update."""

    def __init__(self, schedule, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.05,
                 mask: Optional[Mapping[str, bool]] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None,
                 max_grad_norm: Optional[float] = None,
                 stochastic_round: bool = False, sr_noise: str = "hw"):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype
        self.max_grad_norm = max_grad_norm
        self.stochastic_round = stochastic_round
        self.sr_noise = sr_noise
        self.layout: Optional[FlatLayout] = None
        self.last_lr: Optional[np.float32] = None

    def _mask(self, params):
        return self.mask if self.mask is not None else {n: True
                                                        for n in params}

    def init(self, params: Mapping[str, torch.Tensor],
             flatten: bool = False) -> FusedAdamWEmaState:
        """Zero moments in ``mu_dtype`` / ``nu_dtype`` (default: each
        parameter's dtype), laid out in flat groups. ``flatten=True`` also
        moves the parameters into flat buffers of their own (views; see
        ``FlatLayout.flatten_params_``); ``self.params`` then holds them."""
        self.layout = FlatLayout(params, self._mask(params))
        if flatten:
            self.params = self.layout.flatten_params_(params)
        dev = next(iter(params.values())).device
        return FusedAdamWEmaState(
            0, self.layout.new(dev, lambda g: self.mu_dtype or g.dtype),
            self.layout.new(dev, lambda g: self.nu_dtype or g.dtype))

    def _scalars(self, count: int):
        count_inc = count + 1
        c1 = F32(1.0) - F32(self.b1) ** F32(count_inc)
        c2 = F32(1.0) - F32(self.b2) ** F32(count_inc)
        return c1, c2, F32(self.schedule(count))

    @torch.no_grad()
    def update_with_ema(self, grads, state: FusedAdamWEmaState, params,
                        ema_params, ema_decay, *, generator=None,
                        bits: Optional[Mapping[str, torch.Tensor]] = None):
        """The fused update, in place: ``params``, ``state.mu/nu`` and
        ``ema_params`` are overwritten. Returns (params, new state, ema);
        the new state's count is one more. ``ema_params=None`` skips the
        EMA. ``bits`` (by name, int32 in [0, 65535]) is the stochastic
        rounding's noise in place of draws from ``generator``, for tests
        that pass in the JAX stream."""
        if self.stochastic_round and generator is None and bits is None:
            raise ValueError("stochastic_round=True requires passing "
                             "generator= to update_with_ema")
        layout = params.layout if isinstance(params, FlatDict) \
            else self.layout
        c1, c2, lr = self._scalars(state.count)
        self.last_lr = lr
        clip = self._clip_norm(grads)
        trees = [grads, params, state.mu, state.nu]
        if ema_params is not None:
            trees.append(ema_params)
        flats, copied = zip(*(_flats_of(t, layout) for t in trees))
        bit_flats = None if bits is None else _flats_of(bits, layout)[0]
        one_minus_decay = F32(1.0) - F32(ema_decay)
        for gi, grp in enumerate(layout.groups):
            for lo in range(0, grp.numel, CHUNK):
                sl = slice(lo, min(lo + CHUNK, grp.numel))
                g, p, mu, nu = (f[gi][sl] for f in flats[:4])
                e = flats[4][gi][sl] if ema_params is not None else None
                b = None if bit_flats is None else bit_flats[gi][sl]
                self._chunk(g, p, mu, nu, e, grp.decay, c1, c2, lr, clip,
                            one_minus_decay, generator, b)
        for t, f, c in zip(trees[1:], flats[1:], copied[1:]):
            if c:
                _copy_back(t, layout, f)
        return params, FusedAdamWEmaState(state.count + 1, state.mu,
                                          state.nu), ema_params

    def _clip_norm(self, grads):
        """The global norm to divide the gradients by, or None when there is
        no clip or the norm is below it (a host read of the norm)."""
        if self.max_grad_norm is None:
            return None
        g_norm = _global_norm(grads)
        return None if bool(g_norm < self.max_grad_norm) else g_norm

    def _adam(self, g, p, mu, nu, decay_p, c1, c2, lr, clip):
        """(scaled update, f32 parameter, new mu, new nu) of one leaf or
        chunk: in f32 throughout with stochastic rounding, else in optax's
        dtypes (``b1 * mu`` in mu's dtype)."""
        b1, b2 = self.b1, self.b2
        if clip is not None:
            g = (g / clip.to(g.dtype)) * self.max_grad_norm
        if self.stochastic_round:
            g32, p32 = g.float(), p.float()
            mu_f = g32 * (1 - b1) + mu.float() * b1
            nu_f = (g32 * g32) * (1 - b2) + nu.float() * b2
        else:
            p32 = p
            mu_f = g * (1 - b1) + (mu * _in_dtype(b1, mu.dtype)).to(g.dtype)
            nu_f = (g * g) * (1 - b2) + (nu * _in_dtype(b2, nu.dtype)).to(
                g.dtype)
        u = (mu_f / float(c1)) / (torch.sqrt(nu_f / float(c2)) + self.eps)
        if decay_p:
            u = u + p32 * self.weight_decay
        return u * float(-lr), p32, mu_f, nu_f

    def _chunk(self, g, p, mu, nu, e, decay_p, c1, c2, lr, clip,
               one_minus_decay, generator, bits=None):
        u, p32, mu_f, nu_f = self._adam(g, p, mu, nu, decay_p, c1, c2, lr,
                                        clip)
        if self.stochastic_round and p.dtype == torch.bfloat16:
            p_new = stochastic_round_bf16(p32 + u, generator, self.sr_noise,
                                          bits)
        else:
            p_new = (p32 + u).to(p.dtype)
        p.copy_(p_new)
        mu.copy_(mu_f.to(mu.dtype))
        nu.copy_(nu_f.to(nu.dtype))
        if e is not None:
            e.copy_(_ema_leaf(e, p_new, one_minus_decay))

    def update(self, grads, state: FusedAdamWEmaState, params=None):
        """optax-style (updates, new state): the same math, no parameter
        write and no EMA (for generic callers and tests; the Trainer uses
        ``update_with_ema``)."""
        if self.stochastic_round:
            raise ValueError("stochastic_round needs the fused write-back; "
                             "use update_with_ema(generator=...)")
        c1, c2, lr = self._scalars(state.count)
        clip = self._clip_norm(grads)
        mask = self._mask(grads)
        updates = {}
        with torch.no_grad():
            for n, g in grads.items():
                mu, nu = state.mu[n], state.nu[n]
                updates[n], _, mu_f, nu_f = self._adam(
                    g, params[n], mu, nu, mask[n], c1, c2, lr, clip)
                mu.copy_(mu_f.to(mu.dtype))
                nu.copy_(nu_f.to(nu.dtype))
        return updates, FusedAdamWEmaState(state.count + 1, state.mu,
                                           state.nu)


def _in_dtype(scalar: float, dtype: torch.dtype) -> float:
    """``scalar`` rounded to ``dtype``: JAX converts a Python scalar to the
    array's dtype before a bf16 multiply, where torch would multiply by the
    f32 value."""
    return float(torch.tensor(scalar, dtype=dtype))


def _ema_leaf(e, p_new, one_minus_decay):
    """``e - (1 - decay) * (e - p_new)`` in JAX's dtypes: the inner
    difference in e's dtype, the rest in f32 (decay is an f32 array
    there), cast back to e's dtype."""
    diff = e - p_new.to(e.dtype)
    return (e.float() - diff.float() * float(one_minus_decay)).to(e.dtype) \
        if e.dtype != torch.float32 else e - diff * float(one_minus_decay)


def ema_update(ema_params, new_params, decay):
    """ema <- ema - (1 - decay) * (ema - new), in place, keeping the EMA
    leaves' dtype."""
    omd = F32(1.0) - F32(decay)
    with torch.no_grad():
        for n, e in ema_params.items():
            e.copy_(_ema_leaf(e, new_params[n], omd))
    return ema_params


# ---------------------------------------------------------------------------
# the unfused chain (the counterpart of the optax chain)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transform:
    """A gradient transformation: ``init(params) -> state``,
    ``update(updates, state, params) -> (updates, state)``."""
    init: Callable
    update: Callable


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


@dataclasses.dataclass
class ScaleByAdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None) -> Transform:
    def init(params):
        return ScaleByAdamState(
            0, {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                for n, p in params.items()},
            {n: torch.zeros_like(p) for n, p in params.items()})

    def update(updates, state, params=None):
        count_inc = state.count + 1
        c1 = F32(1.0) - F32(b1) ** F32(count_inc)
        c2 = F32(1.0) - F32(b2) ** F32(count_inc)
        out, mu, nu = {}, {}, {}
        for n, g in updates.items():
            m = g * (1 - b1) + (state.mu[n] * _in_dtype(
                b1, state.mu[n].dtype)).to(g.dtype)
            v = (g * g) * (1 - b2) + state.nu[n] * b2
            out[n] = (m / float(c1)) / (torch.sqrt(v / float(c2)) + eps)
            mu[n] = m.to(mu_dtype or m.dtype)
            nu[n] = v
        return out, ScaleByAdamState(count_inc, mu, nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Mapping[str, bool]] = None
                        ) -> Transform:
    def update(updates, state, params=None):
        return {n: u + params[n] * weight_decay
                if mask is None or mask[n] else u
                for n, u in updates.items()}, state

    return Transform(lambda params: (), update)


def scale_by_learning_rate(schedule: Callable) -> Transform:
    def update(updates, count, params=None):
        lr = F32(schedule(count))
        return {n: u * float(-lr) for n, u in updates.items()}, count + 1

    return Transform(lambda params: 0, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        g_norm = _global_norm(updates)
        if bool(g_norm < max_norm):
            return updates, state
        return {n: (u / g_norm.to(u.dtype)) * max_norm
                for n, u in updates.items()}, state

    return Transform(lambda params: (), update)


@dataclasses.dataclass
class AdoptState:
    count: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adopt(b1: float = 0.9, b2: float = 0.9999, eps: float = 1e-6
          ) -> Transform:
    """ADOPT (arXiv 2411.02853): the second moment initialized from the
    first gradient, momentum on the gradient normalized by the previous
    step's second moment; returns -m (scaled by the LR downstream)."""
    def init(params):
        return AdoptState(0, {n: torch.zeros_like(p) for n, p in
                              params.items()},
                          {n: torch.zeros_like(p) for n, p in
                           params.items()})

    def update(updates, state, params=None):
        m, v, out = {}, {}, {}
        for n, g in updates.items():
            v_prev = state.v[n]
            v[n] = g * g if state.count == 0 else \
                v_prev * b2 + (g * g) * (1 - b2)
            normed = g / torch.sqrt(v_prev).clamp_min(eps)
            if state.count == 0:
                m[n] = torch.zeros_like(g)
            elif state.count == 1:
                m[n] = normed
            else:
                m[n] = state.m[n] * b1 + normed * (1 - b1)
            out[n] = -m[n]
        return out, AdoptState(state.count + 1, m, v)

    return Transform(init, update)


def apply_updates(params, updates):
    """params <- params + updates, in place, in each parameter's dtype."""
    with torch.no_grad():
        for n, p in params.items():
            p.copy_((p + updates[n]).to(p.dtype))
    return params


def make_optimizer(params: Mapping[str, torch.Tensor], *,
                   learning_rate: float = 1e-4,
                   betas: Tuple[float, float] = (0.9, 0.95),
                   transformer_weight_decay: float = 0.05,
                   use_lr_scheduler: bool = True,
                   total_steps: int = 45000,
                   phase_ratio: Tuple[float, float, float] = (0.02, 0.08, 0.9),
                   init_lr_scale: float = 0.1,
                   final_lr_scale: float = 1e-6,
                   max_grad_norm: Optional[float] = None,
                   optimizer_type: str = "adamw",
                   mu_dtype: Optional[torch.dtype] = None,
                   nu_dtype: Optional[torch.dtype] = None,
                   stochastic_round: bool = False,
                   sr_noise: str = "hw",
                   fused: bool = True):
    """AdamW (or ADOPT) + the tri-stage LR and masked weight decay; returns
    (optimizer, schedule). For adamw the default is ``FusedAdamWEma``;
    ``fused=False`` returns the same math as a ``chain`` (with
    ``update(grads, state, params) -> (updates, state)``), as the JAX
    ``fused=False`` returns the optax chain."""
    if use_lr_scheduler:
        schedule = tri_stage_schedule(learning_rate, total_steps, phase_ratio,
                                      init_lr_scale, final_lr_scale)
    else:
        schedule = constant_schedule(learning_rate)
    mask = decay_mask(params)
    if not (optimizer_type == "adamw" and fused):
        if nu_dtype is not None:
            raise ValueError("nu_dtype requires the fused AdamW path")
        if stochastic_round:
            raise ValueError("stochastic_round requires the fused AdamW "
                             "path")
    if optimizer_type == "adamw":
        if fused:
            return FusedAdamWEma(
                schedule, b1=betas[0], b2=betas[1],
                weight_decay=transformer_weight_decay, mask=mask,
                mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                stochastic_round=stochastic_round, sr_noise=sr_noise,
                max_grad_norm=max_grad_norm), schedule
        opt = chain(scale_by_adam(betas[0], betas[1], mu_dtype=mu_dtype),
                    add_decayed_weights(transformer_weight_decay, mask),
                    scale_by_learning_rate(schedule))
    elif optimizer_type == "adopt":
        opt = chain(adopt(b1=betas[0], b2=0.9999),
                    add_decayed_weights(transformer_weight_decay, mask),
                    scale_by_learning_rate(schedule))
    else:
        raise ValueError(f"unknown optimizer_type: {optimizer_type}")
    if max_grad_norm is not None:
        opt = chain(clip_by_global_norm(max_grad_norm), opt)
    return opt, schedule


__all__ = ["tri_stage_schedule", "ema_decay_schedule", "decay_mask",
           "stochastic_round_bf16", "FusedAdamWEma", "FusedAdamWEmaState",
           "make_optimizer", "adopt", "ema_update", "apply_updates", "chain",
           "FlatLayout", "FlatDict"]
