"""Device-resident exploration fleet — the paper's generator processes,
vectorized, on the engine's device.

The paper (§2.2) runs each MD walker as a host process: propose on host,
ship to the prediction kernel, wait for the committee mean, react to the
uncertainty flag.  ``WalkerFleet`` replaces N of those processes with ONE
stacked walker state on the engine's device (positions, velocities,
per-walker noise counters, patience counters) advanced by a sampler step
that is FUSED with acquisition: walker advance → committee forward →
``committee_uq`` statistics → selection-rule pipeline → patience/restart
react run as a single program per shape bucket
(``FusedEngine.score_after``; on the card one captured CUDA graph,
replayed).  Per-walker restart / patience is a device rule
(``PatienceRestart`` — the ``torch.where`` realization of
``core/selection.PatienceTracker``), so the exchange loop collapses to
explore→score→select with the selected oracle candidates as the only
per-iteration host traffic.

Sampler protocol
----------------
A sampler is ``sample(x, v, f, key) -> (x', v')`` in tensor ops over the
stacked ``(nb, d)`` state, with one noise counter pair per walker in
``key`` (``normal_draws``).  Two built-ins:

  'euler'     — ``x + dt * clip(f, ±clip) + noise * N(0, 1)``; with
                ``noise=0`` this reproduces the host ``MDGenerator``
                update exactly (the parity tests drive it).
  'langevin'  — damped velocity dynamics: ``v' = (1-friction) v +
                dt * clip(f) + noise * N(0,1)``, ``x' = x + dt * v'``.

The force driving the advance is the committee MEAN from the PREVIOUS
fused round (``stats.mean`` folded back into the carry by the react step)
— the same information a host generator receives from the exchange
scatter, with zero host round trip.

Noise
-----
The N(0, 1) draws are a counter-based hash of (seed, walker, step), not a
generator's state: ``key[:, 0]`` is the walker's stream (a hash of the seed
and the walker index) and ``key[:, 1]`` its draw counter, advanced every
step.  So the carry holds everything a draw depends on: a resumed fleet
replays bit for bit, the card and the CPU draw the same numbers, and the
program captures as it stands.  The numbers are not JAX's threefry draws:
at ``noise=0`` the port follows the reference's trajectory, at
``noise > 0`` it is held statistically.

Restart semantics
-----------------
``PatienceRestart`` applies the host tracker's exact update on device:
counts increment while a walker stays selected (uncertain), a count
exceeding ``patience`` flags the walker, flagged walkers reset to their
trusted state ``x0`` at the START of the next step (mirroring the host
path, where the generator receives ``None`` and restarts on its next
call).  Non-finite walkers (diverged dynamics, chaos ``nan_walker``)
reset through the same gate instead of crashing the loop.

The carry's tensors are buffers the fleet owns for its whole life: each
step writes the new values into them, and ``load_state_dict`` and
``poison_walker`` copy into them on the engine's stream — a captured
graph reads fixed addresses, so they are never rebound.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.acquisition import STREAM_EXCHANGE, FusedStepOut, _f32
from repro_torch.core.committee import shape_bucket
from repro_torch.training.committee_trainer import _M32, _mix32

_FLEET_IDS = itertools.count()
_STREAM_SALT, _STEP_SALT, _LANE_SALT = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for one walker fleet (``PALRunConfig.fleet_*`` plumbs these).

    ``patience`` follows the host semantics: a walker may stay uncertain
    for up to ``patience`` consecutive steps; the step AFTER that resets
    it to its trusted state.  ``max_steps`` (0 = unbounded) stops the
    exchange loop after that many fleet steps.
    """

    dt: float = 0.002
    clip: float = 20.0
    noise: float = 0.01
    friction: float = 0.1
    sampler: str = "euler"
    patience: int = 5
    max_steps: int = 0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PatienceRestart:
    """Device realization of ``selection.PatienceTracker`` — identical
    update, expressed as ``torch.where`` over the stacked counters:

        counts'   = where(uncertain, counts + 1, 0)
        flag      = counts' > patience
        restarts' = restarts + flag
        counts''  = where(flag, 0, counts')

    ``flag`` marks walkers that must reset to their trusted state on the
    next advance (the host path realizes the same flag as a ``None``
    scatter the generator reacts to one call later)."""

    patience: int

    def apply(self, counts, restarts, uncertain):
        counts = torch.where(uncertain, counts + 1, 0)
        flag = counts > self.patience
        restarts = restarts + flag.to(restarts.dtype)
        counts = torch.where(flag, 0, counts)
        return counts, restarts, flag


def stream_keys(seed: int, nb: int) -> torch.Tensor:
    """(nb, 2) int64 noise counters of a new fleet: walker w's stream
    (a hash of ``seed`` and w) and a draw counter at 0."""
    base = _mix32((int(seed) & _M32) ^ _STREAM_SALT)
    streams = _mix32(torch.arange(nb, dtype=torch.int64) ^ base)
    return torch.stack([streams, torch.zeros_like(streams)], dim=1)


def normal_draws(key: torch.Tensor, d: int) -> torch.Tensor:
    """(nb, d) float32 N(0, 1) draws for the counters ``key`` (nb, 2):
    two 32-bit hashes of (stream, counter, component) per draw, mapped by
    Box–Muller in float64 (so every device rounds to the same float32)."""
    base = _mix32(key[:, 0] ^ _mix32(key[:, 1] ^ _STEP_SALT))
    lanes = _mix32(torch.arange(2 * d, dtype=torch.int64, device=key.device)
                   ^ _LANE_SALT)
    h = _mix32(base[:, None] ^ lanes).to(torch.float64)
    u1 = (h[:, :d] + 1.0) * 2.0 ** -32          # (0, 1]
    u2 = h[:, d:] * 2.0 ** -32                  # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(torch.float32)


def next_keys(key: torch.Tensor) -> torch.Tensor:
    """The counters of the next step: each walker's draw counter + 1."""
    return torch.stack([key[:, 0], (key[:, 1] + 1) & _M32], dim=1)


def make_sampler(cfg: FleetConfig) -> Callable:
    """Build the stacked sampler step ``(x, v, f, key) -> (x', v')``."""
    dt, clip = _f32(cfg.dt), _f32(cfg.clip)
    noise, friction = _f32(cfg.noise), _f32(cfg.friction)

    if cfg.sampler == "euler":
        def sample(x, v, f, key):
            fx = torch.clamp(f, -clip, clip)
            return x + dt * fx + noise * normal_draws(key, x.shape[-1]), v
    elif cfg.sampler == "langevin":
        def sample(x, v, f, key):
            fx = torch.clamp(f, -clip, clip)
            v2 = (1.0 - friction) * v + dt * fx \
                + noise * normal_draws(key, x.shape[-1])
            return x + dt * v2, v2
    else:
        raise ValueError(
            f"fleet sampler {cfg.sampler!r}: expected 'euler' or 'langevin'")
    return sample


# ``key`` leaves a snapshot as uint32, the reference's key dtype (its
# values are below 2**32)
_SNAPSHOT_DTYPE = {"key": np.uint32}


class WalkerFleet:
    """N stacked walkers on the engine's device, one fused program per step.

    The carry never leaves the device on the hot path:

        x          (nb, d)  walker positions (the proposal batch)
        v          (nb, d)  walker velocities ('langevin' sampler)
        f          (nb, d)  committee-mean force from the previous round
        key        (nb, 2)  per-walker noise counters (stream, draw; int64)
        counts     (nb,)    consecutive-uncertain counters (PatienceRestart)
        restarts   (nb,)    realized patience restarts per walker
        flag       (nb,)    walkers that must reset on the next advance
        x0         (nb, d)  trusted restart states
        step       scalar   fleet step counter (first-call semantics)
        nan_resets scalar   walkers reset because they went non-finite

    ``step()`` calls ``engine.score_after``: the sampler advance, the
    committee forward, the ``committee_uq`` statistics, the rule pipeline
    and the patience/restart react all run inside ONE program; the host
    receives the selected oracle candidates and one int32 count.  The
    committee output dimension must equal the walker dimension (forces).
    ``n_valid`` and the stream tag are uploaded when the fleet is built, so
    a step uploads nothing.

    ``engine`` must be a ``FusedEngine`` — the legacy per-member backend
    has no fused step entry point (the runtime enforces this).

    On a mesh engine whose bucket splits its rows, each rank's carry holds
    its rows of the per-walker leaves (``engine.place_carry``) — the noise
    counters beside the positions, so every walker draws the noise it
    draws unsharded — and ``step``, ``nan_resets`` and the program run on
    every rank (SPMD).  ``nan_resets`` then counts this rank's walkers;
    the inspection and checkpoint methods gather the rows and sum the
    counts over the ranks (collectives: every rank calls them).
    """

    def __init__(self, engine, x0: np.ndarray, cfg: FleetConfig,
                 monitor=None, chaos=None):
        if not hasattr(engine, "score_after"):
            raise ValueError(
                "WalkerFleet needs a fused acquisition engine "
                "(FusedEngine.score_after); the legacy per-member backend "
                "cannot fuse the walker advance with scoring")
        x0 = np.asarray(x0, np.float32)
        if x0.ndim != 2:
            raise ValueError(
                f"fleet x0 must be (n_walkers, dim), got {x0.shape}")
        self.engine = engine
        self.cfg = cfg
        self.monitor = monitor
        self.chaos = chaos
        self.n_walkers, self.dim = int(x0.shape[0]), int(x0.shape[1])
        self.nb = shape_bucket(self.n_walkers, engine.min_bucket)
        self.restart_rule = PatienceRestart(cfg.patience)
        self._sampler = make_sampler(cfg)
        # one program per fleet instance: different fleets (different
        # sampler/patience closures) on the same engine must not collide
        self._cache_key = f"fleet{next(_FLEET_IDS)}"
        self.steps_done = 0
        self.last: Optional[FusedStepOut] = None

        pad = np.zeros((self.nb, self.dim), np.float32)
        pad[:self.n_walkers] = x0
        self._carry: Dict[str, Any] = engine.place_carry({
            "x": torch.from_numpy(pad),
            "v": torch.zeros(self.nb, self.dim),
            "f": torch.zeros(self.nb, self.dim),
            "key": stream_keys(cfg.seed, self.nb),
            "counts": torch.zeros(self.nb, dtype=torch.int32),
            "restarts": torch.zeros(self.nb, dtype=torch.int32),
            "flag": torch.zeros(self.nb, dtype=torch.bool),
            "x0": torch.from_numpy(pad.copy()),
            "step": torch.zeros((), dtype=torch.int32),
            "nan_resets": torch.zeros((), dtype=torch.int32),
        }, self.nb)
        engine.bind_step(self._cache_key, self._carry, self.n_walkers,
                         self.nb, STREAM_EXCHANGE)

    # ------------------------------------------------------------- device fns
    def _step_fn(self, carry):
        """Advance all walkers (inside the fused program).

        Order matches the host generator's reaction protocol: first react
        to LAST round's outcome (restart flagged walkers to x0), then
        advance with the sampler.  The very first step proposes the
        initial states unchanged — the host generators' first-call
        semantics, so scoring starts from the trusted configurations."""
        first = carry["step"] == 0
        bad = ~torch.all(torch.isfinite(carry["x"]), dim=-1)
        reset = carry["flag"] | bad
        r = reset[:, None]
        x = torch.where(r, carry["x0"], carry["x"])
        v = torch.where(r, 0.0, carry["v"])
        f = torch.where(r, 0.0, carry["f"])

        x_adv, v_adv = self._sampler(x, v, f, carry["key"])
        # a freshly restarted (or first-step) walker proposes its trusted
        # state itself, exactly like a host generator receiving None
        skip = (first | reset)[:, None]
        x = torch.where(skip, x, x_adv)
        v = torch.where(skip, v, v_adv)
        # dynamics can still diverge within the advance itself
        blown = ~torch.all(torch.isfinite(x), dim=-1)
        x = torch.where(blown[:, None], carry["x0"], x)
        v = torch.where(blown[:, None], 0.0, v)
        nan_hits = torch.sum(bad | blown).to(torch.int32)

        mid = dict(
            carry, x=x, v=v, key=next_keys(carry["key"]),
            counts=torch.where(reset, 0, carry["counts"]),
            flag=torch.zeros_like(carry["flag"]),
            nan_resets=carry["nan_resets"] + nan_hits)
        return x, mid

    def _react_fn(self, mid, stats, mask):
        """Fold the round's outcome back into the carry (inside the
        program): patience counters advance on the selection mask, the
        committee mean becomes next step's driving force."""
        counts, restarts, flag = self.restart_rule.apply(
            mid["counts"], mid["restarts"], mask)
        return dict(mid, counts=counts, restarts=restarts, flag=flag,
                    f=stats.mean, step=mid["step"] + 1)

    # ------------------------------------------------------------------ step
    def step(self) -> FusedStepOut:
        """One fused explore→score→select round.  Host traffic: the
        selected oracle candidates plus one int32 count — nothing for
        unselected walkers."""
        if self.chaos is not None:
            ev = self.chaos.take("fleet.step")
            if ev is not None:
                if ev.kind == "nan_walker":
                    self.poison_walker(int(ev.arg))
                else:
                    self.chaos.execute(ev)
        carry, out = self.engine.score_after(
            self._step_fn, self._carry, self.n_walkers, self.nb,
            react_fn=self._react_fn, cache_key=self._cache_key)
        self._carry = carry
        self.steps_done += 1
        self.last = out
        return out

    # ------------------------------------------------------------ inspection
    def _read(self, fn) -> np.ndarray:
        """``fn()`` (a tensor made from the carry) copied to the host,
        ordered after every program on the engine's stream."""
        return self.engine.carry_call(lambda: fn().cpu()).numpy()

    def _whole(self, name: str) -> torch.Tensor:
        """A carry leaf over every walker: a per-walker leaf's rows of
        every rank, ``nan_resets`` summed over the ranks, ``step`` as it
        is (the same on every rank)."""
        t = self._carry[name]
        if name == "nan_resets":
            return self.engine.sum_rows(t, self.nb)
        return self.engine.gather_rows(t, self.nb) if t.dim() else t

    def positions(self) -> np.ndarray:
        """(n_walkers, d) host snapshot of walker positions — diagnostics
        and tests only; the hot loop never calls this."""
        return self._read(
            lambda: self._whole("x")[:self.n_walkers]).copy()

    def stats(self) -> Dict[str, Any]:
        """Host snapshot of fleet health (PAL.report) — one transfer per
        call, off the hot path."""
        n = self.n_walkers
        v = self._read(lambda: torch.cat([
            self._whole("step").reshape(1),
            self._whole("nan_resets").reshape(1),
            self._whole("restarts")[:n], self._whole("counts")[:n]]))
        return {
            "walkers": n,
            "steps": int(v[0]),
            "restarts": int(np.sum(v[2:2 + n])),
            "nan_resets": int(v[1]),
            "uncertain_streak_max": int(np.max(v[2 + n:])) if n else 0,
        }

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Full host-numpy snapshot of the carry — including the per-walker
        noise counters and step counter, so a restored fleet replays the
        exact trajectory (bit-identical resume)."""
        keys = sorted(self._carry)
        host = self.engine.carry_call(
            lambda: [self._whole(k).cpu() for k in keys])
        return {k: t.numpy().astype(_SNAPSHOT_DTYPE.get(k, t.numpy().dtype))
                for k, t in zip(keys, host)}

    def load_state_dict(self, state: Dict[str, np.ndarray]):
        """Copy a snapshot (this package's, or a reference fleet's with the
        same walker bucket) into the carry's buffers — on a mesh, this
        rank's rows (and ``nan_resets`` on the first rank of the rows)."""
        if set(state) != set(self._carry):
            raise ValueError(
                f"fleet snapshot keys {sorted(state)} do not match the "
                f"carry {sorted(self._carry)}")
        r0, r1 = self.engine.rows_of(self.nb)
        src = {}
        for k, buf in self._carry.items():
            a = np.asarray(state[k])
            whole = (self.nb,) + tuple(buf.shape[1:]) if buf.dim() \
                else ()
            if tuple(a.shape) != whole:
                raise ValueError(
                    f"fleet snapshot {k!r} has shape {a.shape}, the carry "
                    f"{whole}")
            if buf.dim():
                a = a[r0:r1]
            elif k == "nan_resets" and r0:
                a = np.zeros_like(a)
            src[k] = torch.from_numpy(np.array(
                a, dtype=torch.empty((), dtype=buf.dtype).numpy().dtype))

        def copy():
            for k, buf in self._carry.items():
                buf.copy_(src[k].to(buf.device))

        self.engine.carry_call(copy)

    # ----------------------------------------------------------------- chaos
    def poison_walker(self, i: int):
        """Set walker i's position non-finite (chaos ``nan_walker``): the
        next fused step routes it through the restart gate — reset to its
        trusted state, never a crash."""
        r0, r1 = self.engine.rows_of(self.nb)
        if r0 <= i < r1:
            self.engine.carry_call(
                lambda: self._carry["x"][i - r0].fill_(float("nan")))
