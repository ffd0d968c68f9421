"""setup_first_op_s (s, program span): the self time of the program's
`fsw.setup.first_op`, the process's first call into the port's
`torch.library` ops (ops/), without its `fsw.setup.kernel_load` children
(loading, or building, a kernel library).  Nothing where the program
recorded no such span."""

from portbench import program

FIRST, LOAD = 'fsw.setup.first_op', 'fsw.setup.kernel_load'


def value(spans):
    first = [s for s in spans if s.name == FIRST]
    if not first:
        return None
    s = first[0]
    loads = sum(program.seconds(k) for k in spans
                if k.name == LOAD and k.parent == FIRST
                and program.inside(k, s))
    return program.seconds(s) - loads


def read(ctx):
    return value(program.spans())
