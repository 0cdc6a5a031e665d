"""Median latency (ms) from an image's arrival to its output being
ready, over every image handed over in the measured window: the middle
of the distribution whose tail is image_p95_ms."""

import statistics


def read(r):
    if not r.roll.latencies:
        return None
    return 1e3 * statistics.median(r.roll.latencies)
