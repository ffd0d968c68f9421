"""host_batch_build_ms (ms, host clock): the host's own work on a batch in
the traced part, the mean a step of the sampler's call and the padded CSR
graph's build (`graph.from_edge_index`), timed by the driver around the
program's calls (its `tally`'s `host_s`).  The copies to the card and the
wait for the card that the first of them makes are left out.  Nothing
where the driver times no host work."""


def read(ctx):
    work = ctx['window'].get('traced_work', {})
    n = ctx['traced_steps']
    if 'host_s' not in work or n <= 0:
        return None
    return 1e3 * (work['host_s']['sample'] + work['host_s']['csr']) / n
