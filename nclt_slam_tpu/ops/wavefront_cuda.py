"""Build and JAX binding of the CUDA wavefront relaxation (wavefront.cu).

The shared library is compiled from the ``.cu`` source in this directory
with ``nvcc`` for ``sm_90a`` into ``ops/build/`` (gitignored), at first use
on a machine with an NVIDIA GPU, or ahead of time with

    python -m nclt_slam_tpu.ops.wavefront_cuda

The file name carries a hash of the source, so an edited kernel is rebuilt
and a stale library is never loaded.  Callers reach the kernel through
``planning.wavefront.relax``, which picks it on the CUDA platform only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

SOURCE = Path(__file__).with_name("wavefront.cu")
BUILD_DIR = Path(__file__).with_name("build")
TARGET = "nclt_wavefront_relax"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_registered = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libwavefront_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = out.with_suffix(".so.partial")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", str(partial), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(partial, out)
    return out


def _cuda_present() -> bool:
    try:
        return bool(jax.devices("cuda"))
    except RuntimeError:
        return False


def register() -> None:
    """Build (if needed), load and register the FFI target for CUDA."""
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.WavefrontRelax), platform="CUDA")
    _registered = True


def relax_cuda(tc, phi0, n_iter: int):
    """``n_iter`` Jacobi sweeps over (..., R, C) windows in one launch.

    Leading axes are a batch: under ``vmap`` the whole route batch reaches
    the kernel as one call (one thread-block cluster per window)."""
    if _cuda_present():
        register()
    call = jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct(tc.shape, jnp.float32),
        vmap_method="broadcast_all")
    return call(tc.astype(jnp.float32), phi0.astype(jnp.float32),
                n_iter=np.int32(n_iter))


if __name__ == "__main__":
    print(build())
