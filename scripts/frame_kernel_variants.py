#!/usr/bin/env python3
"""What bounds the Space Invaders and Amidar frame kernels: each kernel as
it is, beside variants that leave out part of its work, timed on the card.

    python3 scripts/frame_kernel_variants.py

Each variant is the kernel's source (toybox_tpu_torch/csrc/<kernel>.cu)
with one text substitution, built by nvcc with the port's flags into
build/variants/ (all at once, its headers from csrc/), and launched
through its C entry point on chip_smoke.py's random-play states:
  - "as is": the kernel unchanged (exact against its plain version);
  - "store only": every chunk stores the background; the prep pass, the
    barrier and the 16-byte stores stay (what the kernel costs without
    its composition);
  - "first frame only": the fused form composes only the first frame (the
    cost of the second frame's composition and the byte max);
  - "or for max": the fused form ORs the two frames' words instead of
    their byte max (the cost of __vmaxu4).
Prints, for each, the kernel's own device time (torch.profiler, 50
launches) at N = 1024, 256 and 10, single and fused, and whether the
output equals the plain version's. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from toybox_tpu_torch.ops import render_cuda  # noqa: E402

OUT = ROOT / "build" / "variants"
ENVS = (1024, 256, 10)

# (kernel, variant) -> [(text in the source, its replacement)]
VARIANTS = {
    ("si_frame", "as is"): [],
    ("si_frame", "store only"): [
        ("    compose_chunk(fr[0].row[r], x0, fr[0], c, w);",
         "    for (int k = 0; k < 4; ++k) w[k] = c.word[kBg];"),
        ("    if (fused) {\n      uint32_t v[4];",
         "    if (false) {\n      uint32_t v[4];")],
    ("si_frame", "first frame only"): [
        ("    if (fused) {\n      uint32_t v[4];",
         "    if (false) {\n      uint32_t v[4];")],
    ("si_frame", "or for max"): [
        ("for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);",
         "for (int k = 0; k < 4; ++k) w[k] |= v[k];")],
    ("amidar_frame", "as is"): [],
    ("amidar_frame", "store only"): [
        ("    for (int f = 0; f < frames; ++f) {\n      uint32_t v[4];",
         "    for (int k = 0; k < 4; ++k) w[k] = c.bg_word;\n"
         "    for (int f = 0; f < 0; ++f) {\n      uint32_t v[4];")],
    ("amidar_frame", "first frame only"): [
        ("    for (int f = 0; f < frames; ++f) {\n      uint32_t v[4];",
         "    for (int f = 0; f < 1; ++f) {\n      uint32_t v[4];")],
    ("amidar_frame", "or for max"): [
        ("for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);",
         "for (int k = 0; k < 4; ++k) w[k] |= v[k];")],
}


def write_variant(kernel: str, variant: str, subs) -> Path:
    src = (render_cuda.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{kernel} {variant}: source text not found:"
                               f"\n{old}")
        src = src.replace(old, new)
    path = OUT / f"{kernel}-{variant.replace(' ', '_')}.cu"
    path.write_text(src)
    return path


def build_all() -> dict:
    """{(kernel, variant): library path}, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    running = {}
    for (kernel, variant), subs in VARIANTS.items():
        src = write_variant(kernel, variant, subs)
        lib = src.with_suffix(".so")
        running[kernel, variant] = (lib, subprocess.Popen(
            [*render_cuda._nvcc(), *render_cuda.NVCC_FLAGS,
             f"-I{render_cuda.CSRC}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("frame_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = build_all()
    stream = torch.cuda.current_stream().cuda_stream
    for g in chip_smoke.GAMES:
        if g.kernel not in {k for k, _ in VARIANTS}:
            continue
        cfg = g.module.default_config("cuda")
        consts = g.consts(cfg)
        host = (ctypes.c_float * len(consts))(*consts)
        s1, s2 = g.states(cfg, max(ENVS), 1)
        p1, p2 = g.prep(cfg, s1), g.prep(cfg, s2)
        preps = (p1[:, None].contiguous(), torch.stack([p1, p2], 1))
        for (kernel, variant), lib in libs.items():
            if kernel != g.kernel:
                continue
            fn = getattr(ctypes.CDLL(str(lib)), kernel)
            fn.argtypes = render_cuda._FRAME_ARGS
            fn.restype = ctypes.c_int
            cells = []
            for fused in (0, 1):
                for n in ENVS:
                    prep = preps[fused][:n]
                    out = torch.empty((n, g.module.HEIGHT, g.module.WIDTH),
                                      dtype=torch.uint8, device="cuda")

                    def call():
                        rc = fn(prep.data_ptr(), out.data_ptr(), n, fused,
                                host, len(consts), prep.device.index, stream)
                        chip_smoke.check(rc == 0, f"{kernel} {variant}: "
                                                  f"CUDA error {rc}")

                    us = chip_smoke.kernel_ms(call, kernel + "_kernel",
                                              50) * 1e3
                    exact = torch.equal(out, g.ops.frame_plain(prep, consts))
                    cells.append(f"{('single', 'fused')[fused]} N={n} "
                                 f"{us:.2f} us{' exact' if exact else ''}")
            print(f"{kernel} {variant}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
