"""In-loop anomaly detection: robust detectors over loss and step time.

The telemetry spine records what happened; this module notices *when it
goes wrong*, while the run is still going, without touching the run. An
``AnomalyHook`` rides the normal hook cadence, feeds two
``RobustDetector``s (loss value, per-cadence mean step time), and on a
detection:

- journals an ``anomaly`` event (kind, step, value, robust z-score,
  window median) so ``tail_run.py`` and the fleet scraper surface it;
- flips the process ``/healthz`` state to ``degraded`` — a
  200-but-flagged state (obs/exporter.py): the process is still doing
  useful work, routers keep sending traffic, but the flag is visible in
  the body, in ``process_state{state="degraded"}``, and in the
  supervisor's ``/fleet`` view. After ``recovery_cadences`` consecutive
  clean checks the hook restores ``training``.

Detection is deliberately robust rather than parametric: a sliding
window's median/MAD give a z-score that one spike cannot poison (mean/
stddev would chase the outlier it is trying to flag), with an EWMA kept
alongside purely as smoothed context for the journal record. The robust
z is ``|x - median| / (1.4826 * MAD)`` — the 1.4826 factor scales MAD
to a stddev equivalent under normality, so thresholds read in sigmas.

The bit-identical invariant extends to this hook: it only *reads* — one
cadence-gated ``float()`` of the loss tensor (the NaNGuardHook sync
budget) and host-side histogram counters for step time — and never
mutates state, outputs, or control flow. ``bench --faults`` runs it
enabled and asserts the trajectory stays bit-identical to the
obs-disabled run.

A copy of the reference package's `obs/anomaly.py`; the one fetch per
cadence, the reference's ``jax.device_get``, is ``float(outputs[key])``
here. Nothing here imports torch.
"""

from __future__ import annotations

import collections
import logging
import math

from dist_mnist_tpu_torch.obs import events as events_mod

log = logging.getLogger(__name__)

__all__ = ["RobustDetector", "AnomalyHook"]

# MAD -> stddev-equivalent scale under a normal distribution
_MAD_SCALE = 1.4826


class RobustDetector:
    """Sliding-window median/MAD outlier detector with an EWMA sidecar.

    ``check(x)`` scores x against the *current* window, then admits it;
    outliers enter the window too — the median/MAD absorb them, which
    is the point of using robust statistics. Returns a dict verdict
    (anomaly flag, z, median, mad, ewma) or None during warmup.
    """

    def __init__(self, *, window: int = 64, threshold: float = 6.0,
                 warmup: int = 8, ewma_alpha: float = 0.1):
        if window < 4 or warmup < 2:
            raise ValueError(f"window={window} warmup={warmup} too small")
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self._values: collections.deque = collections.deque(maxlen=window)
        self._ewma: float | None = None
        self._alpha = float(ewma_alpha)

    def _median(self, xs: list) -> float:
        xs = sorted(xs)
        n = len(xs)
        mid = xs[n // 2]
        return mid if n % 2 else (xs[n // 2 - 1] + mid) / 2.0

    def check(self, x: float) -> dict | None:
        x = float(x)
        if math.isnan(x):
            return None
        self._ewma = x if self._ewma is None else \
            self._alpha * x + (1 - self._alpha) * self._ewma
        verdict = None
        if len(self._values) >= self.warmup:
            med = self._median(list(self._values))
            mad = self._median([abs(v - med) for v in self._values])
            scale = _MAD_SCALE * mad
            if scale <= 0:
                # a flat window: fall back to a relative-change guard so
                # a constant signal jumping still registers
                scale = max(abs(med) * 1e-3, 1e-12)
            z = abs(x - med) / scale
            verdict = {
                "anomaly": z >= self.threshold,
                "z": z,
                "median": med,
                "mad": mad,
                "ewma": self._ewma,
            }
        self._values.append(x)
        return verdict


class AnomalyHook:
    """Train-loop hook: robust anomaly watch over loss and step time.

    Matches the hooks/base.Hook protocol structurally (no import, so
    this stays usable from obs without the hooks package). Cadence and
    sync budget follow NaNGuardHook: one ``float()`` of the loss tensor
    per ``every_steps``; step time comes free from the loop's
    ``step_time_hist`` sum/count deltas (no device sync at all).
    """

    def __init__(self, *, key: str = "loss", every_steps: int = 25,
                 health=None, threshold: float = 6.0, window: int = 64,
                 warmup: int = 8, recovery_cadences: int = 3):
        self._key = key
        self._every = max(1, int(every_steps))
        self._health = health
        self._loss_det = RobustDetector(window=window, threshold=threshold,
                                        warmup=warmup)
        self._step_det = RobustDetector(window=window, threshold=threshold,
                                        warmup=warmup)
        self._recovery = max(1, int(recovery_cadences))
        self._next_check: int | None = None
        self._prev_count = 0
        self._prev_sum = 0.0
        self._degraded = False
        self._clean_streak = 0
        self.anomalies: list[dict] = []  # for bench harnesses / tests
        self.last: dict = {}

    # -- hook protocol ---------------------------------------------------------

    def begin(self, loop):
        self._loop = loop
        self._next_check = loop.initial_step + self._every
        hist = getattr(loop, "step_time_hist", None)
        if hist is not None:
            self._prev_count, self._prev_sum = hist.count, hist.sum

    def before_step(self, step):
        pass

    def after_step(self, step, state, outputs):
        if self._next_check is None or step < self._next_check:
            return
        self._next_check = step + self._every
        found = []
        if self._key in outputs:
            # the NaNGuardHook budget: ONE scalar fetch per cadence
            val = float(outputs[self._key])
            v = self._loss_det.check(val)
            self.last["loss"] = val
            if v is not None and v["anomaly"]:
                found.append(("loss", val, v))
        hist = getattr(self._loop, "step_time_hist", None)
        if hist is not None:
            d_count = hist.count - self._prev_count
            d_sum = hist.sum - self._prev_sum
            self._prev_count, self._prev_sum = hist.count, hist.sum
            if d_count > 0:
                mean_ms = d_sum / d_count
                v = self._step_det.check(mean_ms)
                self.last["step_time_ms"] = mean_ms
                if v is not None and v["anomaly"]:
                    found.append(("step_time", mean_ms, v))
        if found:
            self._clean_streak = 0
            for kind, value, v in found:
                rec = {"kind": kind, "step": int(step),
                       "value": round(float(value), 6),
                       "zscore": round(v["z"], 3),
                       "median": round(v["median"], 6),
                       "ewma": round(v["ewma"], 6)}
                self.anomalies.append(rec)
                log.warning("anomaly: %s=%g at step %d (z=%.1f, median=%g)",
                            kind, value, step, v["z"], v["median"])
                events_mod.emit("anomaly", **rec)
            self._set_degraded(found)
        else:
            self._maybe_recover(step)

    def end(self, state):
        # leave /healthz to the loop's terminal transition; a run ending
        # while degraded still reports stopped/failed from the loop
        pass

    # -- health plumbing -------------------------------------------------------

    def _set_degraded(self, found) -> None:
        if self._health is None or self._degraded:
            self._degraded = True
            return
        # only shade *training*: draining/preempted/etc. outrank us
        if self._health.state == "training":
            kinds = ",".join(sorted({k for k, _, _ in found}))
            self._health.set("degraded", f"anomaly: {kinds}")
        self._degraded = True

    def _maybe_recover(self, step) -> None:
        if not self._degraded:
            return
        self._clean_streak += 1
        if self._clean_streak < self._recovery:
            return
        self._degraded = False
        self._clean_streak = 0
        if self._health is not None and self._health.state == "degraded":
            self._health.set("training", f"recovered at step {step}")
        events_mod.emit("anomaly_cleared", step=int(step))
