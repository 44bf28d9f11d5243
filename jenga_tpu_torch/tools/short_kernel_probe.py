"""What holds D's short-key kernel (``csrc/dense_attn_short.cu``): the
kernel as built, timed beside variants that each leave out one part of
its work, on one card in turns.

    python -m jenga_tpu_torch.tools.short_kernel_probe

A variant is the kernel's source with one edit, built like the kernel
(``cuda_build.build_library``, into ``jenga_tpu_torch/_build/``):
``no_store`` writes no row of O, ``no_exp`` takes P = s * scale - m
without the exp2, ``no_mma`` issues no tensor-core product (S and O keep
what their registers held). Their outputs are wrong by design and only
their times are read; no path of the port builds them. Cases: Wan 1.3B's
cross-attention (2 x 12 x 32,768 rows over 512 keys) and Wan2.1-14B's
image (2 x 40 x 32,768 over 257 keys) and text (512 keys)
cross-attention. Each case times the kernel and the variants in that
order and again in reverse, and reports the mean of the two.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from ..ops import flash_attention as fa
from ..ops.cuda_build import CSRC, build_library
from ._common import gpu_line, resolve_device, time_ms

__all__ = ["run", "print_table", "VARIANTS", "CASES"]

# variant: (the source text it replaces, the replacement)
VARIANTS = {
    "no_store": ("    const bool keep = row < p.sq;",
                 "    const bool keep = false;"),
    "no_exp": ("const float x = ex2(fmaf(sc[i], scale2, "
               "-m_row[(i >> 1) & 1]));",
               "const float x = fmaf(sc[i], scale2, -m_row[(i >> 1) & 1]);"),
    "no_mma": ("  if constexpr (PC > 0) issue_pv<PC>(o, pa, vt);\n"
               "  issue_s(sc, qa, kt);\n", ""),
}
CASES = (("wan1.3b_text_x512", 12, 512), ("wan14b_image_x257", 40, 257),
         ("wan14b_text_x512", 40, 512))
ROWS = 32768
_VARIANT_ROOT = (pathlib.Path(__file__).resolve().parent.parent / "_build"
                 / "variants")


def variant_source(name: str) -> str:
    """The short-key kernel's source with VARIANTS[name]'s edit."""
    old, new = VARIANTS[name]
    src = fa.SHORT_KERNEL_SOURCE.read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the text it edits is not once in "
                           f"{fa.SHORT_KERNEL_SOURCE.name}")
    return src.replace(old, new)


def _build_variant(name: str) -> ctypes.CDLL:
    d = _VARIANT_ROOT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / fa.SHORT_KERNEL_SOURCE.name).write_text(variant_source(name))
    for header in CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    return fa.bind_short_kernel(
        build_library(d / fa.SHORT_KERNEL_SOURCE.name))


def _launcher(lib, q, k, v):
    """A zero-argument call of ``lib``'s kernel on contiguous [B, H, S, D]
    operands (no kv_len, no statistics)."""
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in fa._map_strides(x)))
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch():
        err = lib.dense_attn_short_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            None, b, h, sq, k.shape[2], strides, d ** -0.5, stream)
        if err:
            raise RuntimeError("short_kernel_probe launch failed: "
                               + lib.dense_attn_short_error_string(err)
                               .decode())
    return launch


def run(*, reps: int = 20):
    """{case: {"shape": [q, k], "ms": {"kernel" or variant: ms}}} on the
    card (the tool refuses to run without one)."""
    device = resolve_device("cuda")
    libs = {"kernel": fa.build_short_kernel(),
            **{name: _build_variant(name) for name in VARIANTS}}
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for case, heads, skv in CASES:
        q, k, v = (torch.randn((2, heads, n, 128), generator=gen,
                               device=device, dtype=torch.bfloat16)
                   for n in (ROWS, skv, skv))
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(time_ms(_launcher(libs[name], q, k, v), reps,
                                       device))
        out[case] = {"shape": [list(q.shape), list(k.shape)],
                     "ms": {name: sum(t) / len(t)
                            for name, t in times.items()}}
        del q, k, v
    return out


def print_table(res):
    names = list(next(iter(res.values()))["ms"])
    print(f"{'case':22s}" + "".join(f"{n:>12s}" for n in names))
    for case, rec in res.items():
        print(f"{case:22s}" + "".join(f"{rec['ms'][n]:12.4f}"
                                      for n in names), flush=True)


def main():
    print(gpu_line(), flush=True)
    print_table(run())


if __name__ == "__main__":
    main()
