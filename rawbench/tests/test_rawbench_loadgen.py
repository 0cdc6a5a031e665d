"""The load generator: the closed loop keeps exactly `in_flight` images
outstanding, the open loop hands sets over at their arrival times, and
each image is timed from its arrival; the traffic files and the
per-image edits are data the generator reads."""

import pytest

from rawbench import harness, loadgen

CLOSED = {"arrivals": "closed", "in_flight": 4, "roll_images": 4}


def sets(set_size, rate):
    return loadgen.checked({"arrivals": "sets", "set_size": set_size,
                            "rate": rate, "roll_images": 4})


class Card:
    """A fake device that runs the images in order, `service` seconds
    each, on a fake clock the host advances by `enqueue` a call and by
    `tick` each time it reads the clock."""

    def __init__(self, service, enqueue, tick=1e-6):
        self.t, self.service, self.enqueue, self.tick = \
            0.0, service, enqueue, tick
        self.busy_until, self.outstanding, self.most = 0.0, 0, 0
        self.submits, self.done_at = {}, {}

    def clock(self):
        self.t += self.tick
        return self.t

    def submit(self, i):
        self.submits[i] = self.t
        self.t += self.enqueue
        start = max(self.busy_until, self.t)
        self.busy_until = start + self.service
        self.outstanding += 1
        self.most = max(self.most, self.outstanding)
        return f"out{i}", (i, self.busy_until)

    def done(self, ready):
        if self.t < ready[1]:
            return False
        self.wait(ready)
        return True

    def wait(self, ready):
        i, t_done = ready
        self.t = max(self.t, t_done)
        if i not in self.done_at:
            self.done_at[i] = self.t
            self.outstanding -= 1

    def drive(self, mix, **kw):
        return loadgen.drive(loadgen.checked(mix), self.submit, self.wait,
                             self.done, clock=self.clock, **kw)


@pytest.mark.parametrize("in_flight", [1, 2, 8])
def test_closed_loop_keeps_in_flight_images_outstanding(in_flight):
    card = Card(service=0.010, enqueue=0.001)
    roll = card.drive(dict(CLOSED, in_flight=in_flight), seconds=1.0)
    assert card.most == in_flight
    assert card.outstanding == 0                   # drained after the close
    # paced by the card, one image every 10 ms, once two or more are in
    # flight; one at a time adds each enqueue's 1 ms
    per_image = 0.010 + (0.001 if in_flight == 1 else 0.0)
    assert roll.completed == pytest.approx(1.0 / per_image,
                                           abs=in_flight + 1)
    # what was outstanding at the close completes after it, uncounted in
    # the rate but timed
    assert roll.completed <= roll.submitted <= roll.completed + in_flight
    assert len(roll.latencies) == roll.submitted


def test_closed_loop_times_each_image_from_its_submission():
    card = Card(service=0.010, enqueue=0.001)
    roll = card.drive(CLOSED, seconds=0.5)
    expect = [card.done_at[i] - card.submits[i] for i in sorted(card.done_at)]
    assert roll.latencies == pytest.approx(expect, abs=1e-4)
    # once the queue is full an image waits for the three ahead of it
    assert roll.latencies[-1] == pytest.approx(0.040, abs=0.002)
    assert all(e == pytest.approx(0.001, abs=1e-4) for e in roll.enqueue)


def test_open_loop_hands_each_set_over_at_its_arrival():
    # sets of 4 every 50 ms; the card takes 40 ms for a set
    card = Card(service=0.010, enqueue=0.0005)
    roll = card.drive(sets(4, 80.0), seconds=1.0)
    assert roll.submitted == 80
    for n, t in card.submits.items():
        arrival = (n // 4) * 0.05
        assert arrival <= t <= arrival + 0.004
    # below capacity the queue empties between sets: the last of a set
    # waits for the three before it, the first only for itself
    assert card.most == 4
    assert max(roll.latencies) == pytest.approx(0.0405, abs=1e-3)
    assert min(roll.latencies) == pytest.approx(0.0105, abs=1e-3)
    # every image is seen ready when it is (the loop polls between
    # arrivals), so the rate is the offered one
    assert roll.completed == 80


def test_open_loop_times_from_the_arrival_when_it_falls_behind():
    # offered 200 images a second, served 100: the queue grows to the
    # cap and the latency, from each arrival, keeps growing
    card = Card(service=0.010, enqueue=0.0005)
    roll = card.drive(sets(2, 200.0), seconds=1.0)
    assert card.most <= loadgen.MAX_OUTSTANDING
    assert roll.completed == pytest.approx(100, abs=2)
    assert roll.latencies[-1] > 10 * roll.latencies[0]


def test_keeps_the_first_image_at_or_after_each_keep_time():
    card = Card(service=0.010, enqueue=0.001)
    roll = card.drive(dict(CLOSED, in_flight=2), seconds=1.0,
                      keep_at=[0.0, 0.25, 0.2501, 0.9])
    kept = [n for n, _ in roll.kept]
    assert kept == sorted(set(kept))
    assert len(kept) == 3 and kept[0] == 0
    assert all(out == f"out{n}" for n, out in roll.kept)


@pytest.mark.parametrize("mix", [CLOSED, {"arrivals": "sets", "set_size": 3,
                                          "rate": 1000.0, "roll_images": 2}])
def test_max_images_stops_submitting(mix):
    card = Card(service=0.010, enqueue=0.001)
    roll = card.drive(mix, max_images=7)
    assert roll.submitted == 7 and len(card.done_at) == 7


def test_traffic_files_load():
    assert loadgen.load("roll")["in_flight"] == 8
    mix = loadgen.load("sets8")
    assert mix["set_size"] == 8 and mix["rate"] > 0
    assert mix["source"] == mix["sink"] == "device" and mix["edits"] == []


@pytest.mark.parametrize("bad", [
    {"arrivals": "poisson", "roll_images": 4},
    {"arrivals": "closed", "in_flight": 0, "roll_images": 4},
    {"arrivals": "sets", "set_size": 8, "roll_images": 4},
    dict(CLOSED, sink="disk"),
    dict(CLOSED, edits=[["exposure", "exposure"]]),
])
def test_a_mix_the_generator_cannot_drive_is_refused(bad):
    with pytest.raises(ValueError):
        loadgen.checked(bad)


def test_edits_give_each_image_its_own_history_from_the_seed(small_cfg):
    cfg = small_cfg("develop24.roll")
    mix = loadgen.checked(dict(CLOSED, roll_images=6, edits=[
        ["exposure", "exposure", [-1.0, 0.0, 1.0]],
        ["channelmixerrgb", "temperature", [4000.0, 6500.0]]]))
    a = harness.histories(cfg, mix, 2**31 + 1)
    assert a == harness.histories(cfg, mix, 2**31 + 1)
    assert a != harness.histories(cfg, mix, 2**31 + 2)
    assert len(a) == 6
    values = {dict(h)["exposure"]["exposure"] for h in a}
    assert values <= {-1.0, 0.0, 1.0} and len(values) > 1
    assert all(dict(h)["channelmixerrgb"]["temperature"] in (4000.0, 6500.0)
               for h in a)
    assert cfg["history"][0][1]["exposure"] == 0.5     # the file untouched
    assert harness.histories(cfg, loadgen.checked(CLOSED), 1) is None
    with pytest.raises(ValueError, match="does not hold"):
        harness.histories(cfg, loadgen.checked(dict(CLOSED, edits=[
            ["diffuse", "iterations", [1]]])), 1)
