"""setup_s (s, host clock): from the process's start to the start of the
measured window: imports, the inputs, the model, the kernels' loading (and
building, in a checkout's first run), the warm-up and the checked steps."""


def read(ctx):
    return ctx['setup_s']
