"""Host milliseconds an image spends in the program's `run_padded` call,
which enqueues its work and returns without waiting for the device:
the mean over every image handed over in the measured window (engine:
`CompiledPipe.run_padded` -> `Pipeline.run_steps`).  Read only where
the card's queue of pending launches stays short of full, so that the
call does not wait for the card."""


def read(r):
    if not r.roll.enqueue:
        return None
    return 1e3 * sum(r.roll.enqueue) / len(r.roll.enqueue)
