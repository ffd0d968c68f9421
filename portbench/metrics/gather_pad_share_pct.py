"""gather_pad_share_pct (%, program counter): 100 x the padding entries
the program's table gathers took (`gather.pad_entries`) over all the
entries they took (`gather.entries`), counted from the process's start.
Nothing where no gather counted its padding."""

from portbench import program


def value(counters):
    entries = counters.get('gather.entries', 0)
    pad = counters.get('gather.pad_entries')
    if not entries or pad is None:
        return None
    return 100.0 * pad / entries


def read(ctx):
    return value(program.counters())
