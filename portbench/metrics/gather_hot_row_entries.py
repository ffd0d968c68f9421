"""gather_hot_row_entries (entries, program counter): the most entries
one sender row took in a single table gather whose source autograd
differentiates (`gather.hot_row_entries`): the longest run of PyTorch's
index backward onto one row.  Nothing where no such gather ran."""

from portbench import program


def value(counters):
    return counters.get('gather.hot_row_entries')


def read(ctx):
    return value(program.counters())
