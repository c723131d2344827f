"""``chip_smoke.Timer`` against a simulated card: it times the card, not
the host, whatever the host takes to enqueue a call.

The card is a queue on a clock of its own: a sleep, an event or a kernel
starts when both the card is free and the host has enqueued it. A call
whose enqueue outlasts the sleep ahead of it would leave the card idle
between the events, and the reading would be the host's time.
"""

import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

CYCLES_PER_MS = 2_000_000


class FakeCard:
    """Host and card clocks in ms, and the ``torch`` surface ``Timer``
    touches."""

    def __init__(self):
        self.host = 0.0
        self.card = 0.0
        self.sleep_cycles = []
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.at = None

            def record(self):
                self.at = card.card = max(card.card, card.host)

            def query(self):
                return self.at <= card.host

            def elapsed_time(self, other):
                return other.at - self.at

        def _sleep(cycles):
            self.sleep_cycles.append(cycles)
            self.run(cycles / CYCLES_PER_MS)

        self.torch = types.SimpleNamespace(
            uint8="uint8",
            empty=lambda *a, **k: types.SimpleNamespace(zero_=lambda: None),
            cuda=types.SimpleNamespace(Event=Event, _sleep=_sleep,
                                       synchronize=self.synchronize))
        self.time = types.SimpleNamespace(
            perf_counter=lambda: self.host / 1e3)

    def run(self, ms):
        """Enqueue work of ``ms`` on the card."""
        self.card = max(self.card, self.host) + ms

    def synchronize(self):
        self.host = max(self.host, self.card)

    def call(self, enqueue_ms, kernel_ms, waits=False):
        """A timed call: the host spends ``enqueue_ms`` and then launches
        one kernel of ``kernel_ms``; ``waits`` first waits on the card."""
        def fn():
            if waits:
                self.synchronize()
            self.host += enqueue_ms
            self.run(kernel_ms)
        return fn


@pytest.fixture
def card(monkeypatch):
    c = FakeCard()
    monkeypatch.setattr(CS, "time", c.time)
    return c


@pytest.mark.parametrize("enqueue_ms", [0.05, 0.4, 3.0, 70.0])
def test_the_reading_is_the_kernel_however_slow_the_enqueue(card,
                                                            enqueue_ms):
    timer = CS.Timer(card.torch, reps=5)
    assert timer.cycles_per_ms == pytest.approx(CYCLES_PER_MS)
    assert timer(card.call(enqueue_ms, 0.05)) == pytest.approx(0.05)
    # an enqueue the first sleep covers is never made again
    assert (timer.redone == 0) == (enqueue_ms < 1.0)
    assert (timer.calls, timer.waiting) == (1, 0)


def test_work_queued_ahead_covers_the_enqueue(card):
    """A call whose card time outlasts its enqueue covers the next rep's
    enqueue itself: only the first rep, behind an idle card, is made
    again."""
    timer = CS.Timer(card.torch, reps=5)
    assert timer(card.call(3.0, 20.0)) == pytest.approx(20.0)
    assert timer.redone == 2


def test_the_sleep_shrinks_again_after_a_stall(card):
    """A stall of slow enqueues raises the sleep; the quick ones after it
    halve it back to the first."""
    slow = iter([0.05] + [40.0] * 9)

    def fn():
        card.host += next(slow, 0.05)
        card.run(0.05)

    timer = CS.Timer(card.torch, reps=12)
    card.sleep_cycles.clear()
    assert timer(fn) == pytest.approx(0.05)
    assert max(card.sleep_cycles) >= 16 * CS.Timer.SLEEP_CYCLES
    assert card.sleep_cycles[-1] == CS.Timer.SLEEP_CYCLES


@pytest.mark.parametrize("enqueue_ms", [0.2, 3.0])
def test_a_call_that_waits_on_the_card_is_timed_as_it_comes(card,
                                                            enqueue_ms):
    """No sleep covers a call that synchronises: the Timer sees that
    before the reps and makes none of them again."""
    timer = CS.Timer(card.torch, reps=5)
    got = timer(card.call(enqueue_ms, 0.05, waits=True))
    assert timer.redone == 0
    assert got == pytest.approx(enqueue_ms + 0.05)
