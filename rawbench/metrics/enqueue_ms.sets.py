"""Host milliseconds an image spends in the program's `run_padded` call
in an open loop of sets, the mean over every image handed over in the
measured window: the first image of a set waits for its own enqueue
before the card starts on it, so the enqueue enters every set's tail."""


def read(r):
    if not r.roll.enqueue:
        return None
    return 1e3 * sum(r.roll.enqueue) / len(r.roll.enqueue)
