"""Hand-written device kernels, each beside the plain JAX version it must
match (the wavefront relaxation: ops/wavefront.cu, planning/wavefront.py)."""
