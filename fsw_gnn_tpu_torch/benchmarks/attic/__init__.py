"""Kernels kept beside the package but wired into no route: the counterpart
of the repository's `benchmarks/attic/`."""
