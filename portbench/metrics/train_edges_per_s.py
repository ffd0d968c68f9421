"""train_edges_per_s (edges/s, host clock): the real edges (duplicates
merged) of the optimizer steps completed in the measured window, over the
window's seconds (ended by a synchronise).  A cell whose steps train
graphs of their own (sampled batches) counts each step's graph, as its
driver's `tally` sums them after the window; any other cell counts its
one graph's edges times the steps."""


def read(ctx):
    w = ctx['window']
    if 'work' in w:
        return w['work']['edges'] / w['seconds']
    return ctx['edges'] * w['steps'] / w['seconds']
