"""Per-backend words→microseconds calibration (feedback-calibrated planner).

The planner's cost model (``core.planner.estimate_words_touched``) prices
every candidate backend in *words moved through the memory system* -- a
unit that ranks backends on one device but says nothing about wall time,
and whose per-backend exchange rate differs across devices (a word moved
by the fused CUDA kernel costs different nanoseconds than a word moved
by host-side lists or by the gate-by-gate circuit family).

A :class:`Calibration` closes that loop: it holds measured per-backend
roofline constants

    ``cost_us(backend, words) = dispatch_us[backend]
                                + words * us_per_kword[backend] / 1024``

obtained either from a one-off measurement pass
(:func:`measure_calibration` -- small timed executions per backend on a
synthetic index, on the device the index would run on) or fed back from
real executions as they happen (:meth:`Calibration.observe`, an EWMA).
When a calibration is installed (:func:`set_calibration`),
``plan_threshold`` ranks its min-cost candidates by calibrated
microseconds instead of raw words, and every
:class:`~repro_torch.core.planner.Plan` carries both scales (``cost`` /
``candidates`` in words, ``cost_us`` / ``candidates_us`` in µs).

Constants persist as JSON (``repro_torch.persist.calibration``), stamped
with :func:`device_signature`, so a restarted server skips the
measurement pass and never prices with another device's constants.
"""
from __future__ import annotations

import dataclasses
import time

import torch

__all__ = [
    "Calibration",
    "device_signature",
    "get_calibration",
    "set_calibration",
    "clear_calibration",
    "calibration_generation",
    "measure_calibration",
]

#: backends the measurement pass times by default: the device circuit
#: family's representatives plus the specialised paths the planner emits
DEFAULT_BACKENDS = (
    "fused",
    "ssum",
    "tiled_fused",
    "looped",
    "scancount_streaming",
    "wide_or",
    "wide_and",
)

# observations are EWMA-blended with this weight (recent executions
# dominate after ~1/alpha samples)
_EWMA_ALPHA = 0.2

# a single observation can be wildly off (GC pause, first-call compile);
# clamp each observed constant to this band around the running value
_OBS_CLAMP = 8.0

#: device strings exempt from topology-staleness checks: "identity" is the
#: synthetic uniform calibration (device-independent by construction) and
#: "unknown" is the blank default a caller fills by observation
_PORTABLE_DEVICES = ("identity", "unknown")


def device_signature(device=None) -> str:
    """The current execution topology: ``<device type>x<device_count>``.

    ``device`` defaults to the card when one is present, else the CPU (this
    only labels constants; it never chooses where a query runs).  A constant
    measured on one topology is meaningless on another (a sharded dispatch
    amortises differently than a single device; the card's words/µs say
    nothing about the CPU), so calibrations are stamped with this
    signature and reset when it no longer matches -- the EWMA alone never
    recovers from a swap because :meth:`Calibration.observe` clamps each
    sample to a band around the dead running value.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    return f"{kind}x{count}"


@dataclasses.dataclass
class Calibration:
    """Measured per-backend roofline constants for one device.

    ``us_per_kword`` maps backend name to microseconds per 1024 words
    touched; ``dispatch_us`` is the fixed per-execution launch/trace cost.
    Unknown backends have no opinion (``cost_us`` returns None) so the
    planner falls back to the words model for them.
    """

    device: str = "unknown"
    us_per_kword: dict = dataclasses.field(default_factory=dict)
    dispatch_us: dict = dataclasses.field(default_factory=dict)
    samples: dict = dataclasses.field(default_factory=dict)

    def cost_us(self, backend: str, words: float | None) -> float | None:
        """Calibrated microsecond estimate; None without a constant or a
        words estimate.  Strictly monotone in ``words`` for any backend --
        calibration rescales the words model per backend, it never inverts
        the within-backend ordering."""
        k = self.us_per_kword.get(backend)
        if k is None or words is None:
            return None
        return self.dispatch_us.get(backend, 0.0) + float(words) * k / 1024.0

    def is_stale(self, signature: str | None = None) -> bool:
        """True when the constants were recorded on a different topology
        than the current one (portable devices are never stale)."""
        if self.device in _PORTABLE_DEVICES:
            return False
        return self.device != (signature or device_signature())

    def reset_for_device(self, signature: str | None = None) -> None:
        """Drop constants recorded on another topology and re-stamp.

        The EWMA cannot decay its way out of a device swap: each observation
        is clamped to within ``_OBS_CLAMP`` of the running value, so a
        constant that is 1000x wrong on the new topology keeps steering the
        planner essentially forever.  A topology change therefore resets to
        a blank slate; the first observation per backend re-admits at the
        observed rate, and the planner falls back to the words model until
        then."""
        self.device = signature or device_signature()
        self.us_per_kword.clear()
        self.dispatch_us.clear()
        self.samples.clear()

    def observe(self, backend: str, words: float | None, seconds: float) -> None:
        """Fold one measured execution back into the constants (EWMA).

        ``words`` is the plan's estimate for the execution (``Plan.cost``);
        the dispatch floor is attributed first and the remainder prices the
        per-word rate.  Unknown backends are admitted at the observed rate.
        A calibration recorded on a different topology is reset first --
        dead constants must not anchor the clamp band (see
        :meth:`reset_for_device`).
        """
        if words is None or words <= 0 or seconds <= 0:
            return
        if self.is_stale():
            self.reset_for_device()
            if self is _ACTIVE:
                _bump_generation()
        us = seconds * 1e6
        disp = self.dispatch_us.get(backend, 0.0)
        k_obs = max(us - disp, us * 0.1) * 1024.0 / float(words)
        k_old = self.us_per_kword.get(backend)
        if k_old is None:
            self.us_per_kword[backend] = k_obs
        else:
            k_obs = min(max(k_obs, k_old / _OBS_CLAMP), k_old * _OBS_CLAMP)
            self.us_per_kword[backend] = (
                (1.0 - _EWMA_ALPHA) * k_old + _EWMA_ALPHA * k_obs
            )
        self.samples[backend] = int(self.samples.get(backend, 0)) + 1

    # -- (de)serialisation -------------------------------------------------
    def to_obj(self) -> dict:
        return {
            "device": self.device,
            "us_per_kword": {k: float(v) for k, v in sorted(self.us_per_kword.items())},
            "dispatch_us": {k: float(v) for k, v in sorted(self.dispatch_us.items())},
            "samples": {k: int(v) for k, v in sorted(self.samples.items())},
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "Calibration":
        return cls(
            device=str(obj.get("device", "unknown")),
            us_per_kword={str(k): float(v) for k, v in obj.get("us_per_kword", {}).items()},
            dispatch_us={str(k): float(v) for k, v in obj.get("dispatch_us", {}).items()},
            samples={str(k): int(v) for k, v in obj.get("samples", {}).items()},
        )

    @classmethod
    def identity(cls, backends=DEFAULT_BACKENDS, *, us_per_kword: float = 1.0) -> "Calibration":
        """A uniform calibration: every backend pays the same rate, so
        calibrated ranking coincides with the words-touched ranking (the
        regression anchor in tests)."""
        return cls(
            device="identity",
            us_per_kword={b: float(us_per_kword) for b in backends},
        )


# ---------------------------------------------------------------------------
# Active-calibration registry (what the planner consults)
# ---------------------------------------------------------------------------

_ACTIVE: Calibration | None = None
_GENERATION = 0  # bumped on install; plan memos key on it


def _bump_generation() -> None:
    global _GENERATION
    _GENERATION += 1


def get_calibration() -> Calibration | None:
    """The installed calibration, topology-checked: constants recorded on
    a device signature that no longer matches are reset (and the plan-memo
    generation bumped) before the planner can price with them."""
    if _ACTIVE is not None and _ACTIVE.is_stale():
        _ACTIVE.reset_for_device()
        _bump_generation()
    return _ACTIVE


def calibration_generation() -> int:
    """Monotone counter bumped by :func:`set_calibration` -- cache keys
    that embed calibrated prices (the plan memo) include it, so swapping
    constants invalidates stale plans without touching the caches."""
    return _GENERATION


def set_calibration(calib: Calibration | None) -> None:
    global _ACTIVE, _GENERATION
    _ACTIVE = calib
    _GENERATION += 1


def clear_calibration() -> None:
    set_calibration(None)


# ---------------------------------------------------------------------------
# Measurement pass
# ---------------------------------------------------------------------------


def measure_calibration(
    backends=DEFAULT_BACKENDS,
    *,
    n: int = 16,
    n_words: int = 2048,
    repeats: int = 3,
    seed: int = 0,
    device=None,
) -> Calibration:
    """Time each backend on a small synthetic index and derive constants.

    The index lives on ``device`` (default: the CUDA card).  One warm-up
    execution per backend absorbs kernel builds and plan caches, then the
    median of ``repeats`` timed runs -- host wall clock around ``execute``
    and a device synchronise, the time the planner prices -- divides the
    words the planner's own model says the backend touches: the constant
    is the words->µs exchange rate that makes ``Plan.cost`` comparable
    across backends on THIS device.  A backend the model cannot price is
    skipped; a backend that fails raises (every name in
    ``DEFAULT_BACKENDS`` runs on every device).
    """
    import numpy as np

    from repro_torch.core.planner import estimate_words_touched
    from repro_torch.device import resolve_device
    from repro_torch.query import BitmapIndex, Threshold

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed)
    # mixed-density columns so the tiled path has real dirty tiles to price
    bits = rng.random((n, n_words * 32)) < rng.uniform(0.05, 0.5, (n, 1))
    bits[: max(1, n // 4), : (n_words * 16)] = False  # some clean territory
    idx = BitmapIndex.from_dense(bits, device=dev)
    stats = idx.store.member_stats(None)
    calib = Calibration(device=device_signature(dev))
    for backend in backends:
        t = {"wide_or": 1, "wide_and": n}.get(backend, max(2, n // 2))
        q = Threshold(t)
        words = estimate_words_touched(
            backend, n, t, n_words=n_words, stats=stats, density=stats.density
        )
        if words is None:
            continue
        idx.execute(q, backend=backend)  # warm-up
        sync()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            idx.execute(q, backend=backend)
            sync()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        calib.us_per_kword[backend] = med * 1e6 * 1024.0 / float(words)
        calib.samples[backend] = repeats
    return calib
