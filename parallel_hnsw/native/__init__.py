"""Native host-side components (C++), compiled on first use."""

from parallel_hnsw.native.build import load_vecio

__all__ = ["load_vecio"]
