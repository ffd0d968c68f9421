"""device_idle_pct (%, device trace): the share of the traced part of the
window, from its first device operation to the end of its last, in which
no kernel, copy or memset ran on the card."""


def read(ctx):
    t = ctx['trace']
    if t['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
