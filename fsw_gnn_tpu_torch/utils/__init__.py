"""Utilities of the port."""
from .cache import CountingGraph

__all__ = ['CountingGraph']
