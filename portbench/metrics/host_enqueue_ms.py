"""host_enqueue_ms (ms, program span): the host's time a traced Trainer
step, the mean over the program's `fsw.train.step` spans of each step's
time less its waits for the card: its `fsw.train.readback` (the loss's
`.item()`) and any `fsw.wait.*` inside it, a wait inside another counted
once.  The spans are recorded while the profiler runs, so they are the
traced steps.  Nothing where no step was recorded (a replayed graph runs
no spans)."""

from portbench import program

STEP, READBACK, WAIT = 'fsw.train.step', 'fsw.train.readback', 'fsw.wait.'


def value(spans):
    steps = [s for s in spans if s.name == STEP]
    if not steps:
        return None
    waits = [s for s in spans
             if s.name == READBACK or s.name.startswith(WAIT)]
    outer = [w for w in waits if not any(
        o is not w and program.inside(w, o) for o in waits)]
    host = [program.seconds(s) - sum(program.seconds(w) for w in outer
                                     if w.step == s.step
                                     and program.inside(w, s))
            for s in steps]
    return 1e3 * sum(host) / len(host)


def read(ctx):
    return value(program.spans())
