"""Build a CUDA source of ``jenga_tpu_torch/csrc`` into a shared library.

Each kernel source has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` at first use, cached under ``jenga_tpu_torch/_build/<hash>/``
(the hash covers the source and the shared ``csrc/*.cuh`` headers), and
loaded with ``ctypes``; ``ptxas`` resource use lands beside the library in
``ptxas.log``. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

__all__ = ["CSRC", "build_library"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"


def build_library(source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it. Raises with
    nvcc's output if the build fails."""
    from torch.utils.cpp_extension import CUDA_HOME
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / f"lib{source.stem}.so"
    if not lib_path.exists():
        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found (nvcc) to build "
                               f"{source.name}")
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {source.name}:"
                               f"\n{res.stdout}\n{res.stderr}")
        (out_dir / "ptxas.log").write_text(res.stderr)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
