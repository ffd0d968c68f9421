"""train_edges_per_s (edges/s, host clock): the real edges of the cell's
graph (duplicates merged) times the optimizer steps completed in the
measured window, over the window's seconds (ended by a synchronise)."""


def read(ctx):
    w = ctx['window']
    return ctx['edges'] * w['steps'] / w['seconds']
