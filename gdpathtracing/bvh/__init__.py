from gdpathtracing.bvh.blas import BLASBuilder, BLASArrays
from gdpathtracing.bvh.tlas import build_tlas, TLASArrays

__all__ = ["BLASBuilder", "BLASArrays", "build_tlas", "TLASArrays"]
