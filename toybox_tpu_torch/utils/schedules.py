"""Parameter schedules for exploration/lr annealing (port of
toybox_tpu.utils.schedules, plain python).

Same public surface as the reference's baselines/common/schedules.py
(Schedule.value, Constant/Linear/PiecewiseSchedule) but implemented on a
single knot-table core: every schedule is a sorted sequence of (time,
value) knots plus an out-of-range policy, and lookup is a bisect into the
knot times. Schedules are host-side: they feed scalar hyperparameters into
the learners' steps.
"""

from __future__ import annotations

from bisect import bisect_right


def linear_interpolation(l, r, alpha):
    """Affine blend: alpha=0 -> l, alpha=1 -> r."""
    return (1.0 - alpha) * l + alpha * r


class Schedule:
    """A time-indexed scalar: subclasses implement value(t)."""

    def value(self, t):
        raise NotImplementedError

    def __call__(self, t):
        return self.value(t)


class ConstantSchedule(Schedule):
    def __init__(self, value):
        self._constant = value

    def value(self, t):
        return self._constant


class PiecewiseSchedule(Schedule):
    """Interpolates between knots; ``outside_value`` past the last knot.

    ``endpoints`` is a sequence of (t, value) pairs with strictly
    increasing times. Between consecutive knots the value is blended by
    ``interpolation`` (linear by default). Before the first knot the first
    value holds; past the last knot ``outside_value`` is returned (it must
    be provided if value() is ever called there).
    """

    def __init__(self, endpoints, interpolation=linear_interpolation,
                 outside_value=None):
        times = tuple(t for t, _ in endpoints)
        if any(a >= b for a, b in zip(times, times[1:])):
            raise ValueError("PiecewiseSchedule knot times must be "
                             f"strictly increasing, got {times}")
        self._times = times
        self._values = tuple(v for _, v in endpoints)
        self._blend = interpolation
        self._outside_value = outside_value

    def value(self, t):
        if t < self._times[0]:
            return self._values[0]
        if t >= self._times[-1]:
            if self._outside_value is None:
                raise ValueError(
                    f"t={t} is past the last knot and no outside_value set")
            return self._outside_value
        # rightmost knot with time <= t; t is strictly inside the table here
        i = bisect_right(self._times, t) - 1
        span = self._times[i + 1] - self._times[i]
        alpha = (t - self._times[i]) / span
        return self._blend(self._values[i], self._values[i + 1], alpha)


class LinearSchedule(Schedule):
    """Ramp from initial_p to final_p over schedule_timesteps, then hold
    final_p forever (deepq's epsilon-greedy exploration schedule)."""

    def __init__(self, schedule_timesteps, final_p, initial_p=1.0):
        self.schedule_timesteps = schedule_timesteps
        self.final_p = final_p
        self.initial_p = initial_p
        self._core = PiecewiseSchedule(
            [(0, initial_p), (schedule_timesteps, final_p)],
            outside_value=final_p)

    def value(self, t):
        if t <= 0:
            return self.initial_p
        return self._core.value(t)
