"""Utilities of the port."""
from .cache import CountingGraph
from .dsmetric import dsmetric

__all__ = ['CountingGraph', 'dsmetric']
