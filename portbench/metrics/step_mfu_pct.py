"""step_mfu_pct (%, device trace): 100 x the step's floor on the H100
(workmodel.step_work: every layer's FSW embedding forward and backward on
the real entries, the projections and the MLP head's products, the bytes
of X, the edge list, the parameters and the optimizer state) over the
measured time a step in the traced part of the window."""


def read(ctx):
    t, n = ctx['trace'], ctx['traced_steps']
    if n <= 0 or t['window_s'] <= 0:
        return None
    return 100.0 * ctx['step']['floor_s'] * n / t['window_s']
