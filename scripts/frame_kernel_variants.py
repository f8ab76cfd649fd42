#!/usr/bin/env python3
"""What bounds the frame kernels: each kernel as it is, beside variants
that leave out part of its work, timed on the card.

    python3 scripts/frame_kernel_variants.py [kernel ...] [--variant NAME]
        [--csrc DIR]

(kernels: breakout_frame, si_frame, amidar_frame; all by default; each
--variant adds one to run, all by default; --csrc takes the sources from
another checkout's csrc/, to time two trees in one call). Each
variant is the kernel's source (toybox_tpu_torch/csrc/<kernel>.cu) with
text substitutions in it or in a header it includes, built by nvcc with
the port's flags into build/variants/<kernel>-<variant>/ (all at once;
the headers it does not change come from csrc/), and launched through its
C entry point on chip_smoke.py's random-play states:
  - "as is" and "warp as is": the frame and the warp entries unchanged
    (exact against their plain versions);
  - "store only": every chunk stores the background; the prep pass, the
    barrier and the 16-byte stores stay (what the kernel costs without
    its composition);
  - "first frame only": the fused form composes only the first frame (the
    cost of the second frame's composition and the byte max);
  - "or for max" (SI, Amidar): the fused form ORs the two frames' words
    instead of their byte max (the cost of __vmaxu4);
  - for Breakout's warp entry, "compose only": the warp stage composes the
    frame into its stage but skips the contraction (one XOR a word keeps
    the composition alive), and "warp only": the frame is the background
    word, the contraction runs in full.
Prints, for each, the kernel's own device time (torch.profiler, 50
launches) at N = 1024, 256 and 10 (single and fused for the frame entry,
the fused warp for the warp entry), and whether the output equals the
plain version's; then each kernel's count of I2F instructions (integer to
float conversions) in its SASS (cuobjdump). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from toybox_tpu_torch.ops import obs, render_cuda  # noqa: E402

OUT = ROOT / "build" / "variants"
ENVS = (1024, 256, 10)
CSRC = render_cuda.CSRC

_NO_SECOND = ("    if (fused) {\n      uint32_t v[4];",
              "    if (false) {\n      uint32_t v[4];")
_OR_FOR_MAX = ("for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);",
               "for (int k = 0; k < 4; ++k) w[k] |= v[k];")
# Breakout's frame_chunk, which both of its entries compose through
_BK_FIRST = ("  compose_chunk(tb, 0, y, bits & 0x1Fu, chunk, c, w);\n"
             "  if (fused) {")
_BK_NO_SECOND = ("breakout_frame.cu", _BK_FIRST,
                 _BK_FIRST.replace("if (fused)", "if (false)"))

# (kernel, variant) -> (entry: "frame" or "warp", [(file, text in it, its
# replacement)])
VARIANTS = {
    ("breakout_frame", "as is"): ("frame", []),
    ("breakout_frame", "store only"): ("frame", [
        ("breakout_frame.cu", _BK_FIRST,
         "  for (int k = 0; k < 4; ++k) w[k] = c.bg;\n  if (false) {")]),
    ("breakout_frame", "first frame only"): ("frame", [_BK_NO_SECOND]),
    ("breakout_frame", "warp as is"): ("warp", []),
    ("breakout_frame", "compose only"): ("warp", [
        ("warp84.cuh", "  float4* t = s.t[wp];\n",
         "  float4* t = s.t[wp];\n  uint32_t sink = 0;\n"),
        ("warp84.cuh",
         "        for (int b = 0; b < 4; ++b) {\n"
         "          const float v = byte_float(word, b);",
         "        sink ^= word;\n"
         "        for (int b = 0; b < 0; ++b) {\n"
         "          const float v = byte_float(word, b);"),
        ("warp84.cuh", "      if (y != last) continue;",
         "      if (y != last || sink != 1u) continue;")]),
    ("breakout_frame", "warp only"): ("warp", [
        ("breakout_frame.cu",
         "                  frame_chunk(tables, 0, y, chunk, true, c, w);",
         "                  for (int k = 0; k < 4; ++k) w[k] = c.bg;")]),
    ("si_frame", "as is"): ("frame", []),
    ("si_frame", "store only"): ("frame", [
        ("si_frame.cu",
         "    compose_chunk(fr[0].row[r], x0, fr[0], c, w);",
         "    for (int k = 0; k < 4; ++k) w[k] = c.word[kBg];"),
        ("si_frame.cu", *_NO_SECOND)]),
    ("si_frame", "first frame only"): ("frame", [
        ("si_frame.cu", *_NO_SECOND)]),
    ("si_frame", "or for max"): ("frame", [("si_frame.cu", *_OR_FOR_MAX)]),
    ("si_frame", "warp as is"): ("warp", []),
    ("amidar_frame", "as is"): ("frame", []),
    ("amidar_frame", "store only"): ("frame", [
        ("amidar_frame.cu",
         "    for (int f = 0; f < frames; ++f) {\n      uint32_t v[4];",
         "    for (int k = 0; k < 4; ++k) w[k] = c.bg_word;\n"
         "    for (int f = 0; f < 0; ++f) {\n      uint32_t v[4];")]),
    ("amidar_frame", "first frame only"): ("frame", [
        ("amidar_frame.cu",
         "    for (int f = 0; f < frames; ++f) {\n      uint32_t v[4];",
         "    for (int f = 0; f < 1; ++f) {\n      uint32_t v[4];")]),
    ("amidar_frame", "or for max"): ("frame", [
        ("amidar_frame.cu", *_OR_FOR_MAX)]),
    ("amidar_frame", "warp as is"): ("warp", []),
}


def write_variant(kernel: str, variant: str, subs) -> Path:
    """The variant's directory, holding its .cu and each header it
    changes (a quoted include finds the copy beside the .cu first)."""
    path = OUT / f"{kernel}-{variant.replace(' ', '_')}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    files = {f"{kernel}.cu": None}
    files.update({name: None for name, _, _ in subs})
    for name in files:
        files[name] = (CSRC / name).read_text()
    for name, old, new in subs:
        if old not in files[name]:
            raise RuntimeError(f"{kernel} {variant}: text not found in "
                               f"{name}:\n{old}")
        files[name] = files[name].replace(old, new)
    for name, text in files.items():
        (path / name).write_text(text)
    return path / f"{kernel}.cu"


def build_all(kernels, variants) -> dict:
    """{(kernel, variant): library path}, one nvcc each, all at once."""
    running = {}
    for (kernel, variant), (_, subs) in VARIANTS.items():
        if kernel not in kernels or variants and variant not in variants:
            continue
        src = write_variant(kernel, variant, subs)
        lib = src.with_suffix(".so")
        running[kernel, variant] = (lib, subprocess.Popen(
            [*render_cuda._nvcc(), *render_cuda.NVCC_FLAGS,
             f"-I{CSRC}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = lib
    return libs


def i2f_counts(lib: Path) -> str:
    """Each kernel function's count of I2F instructions in the SASS."""
    nvcc = Path(render_cuda._nvcc()[0])
    tool = shutil.which("cuobjdump") or str(nvcc.parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        short = re.findall(r"[a-z]+_frame(?:_warp)?_kernel", name)
        counts.append(f"{short[-1] if short else name} "
                      f"{len(re.findall(r'\bI2F', part))}")
    return ", ".join(counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("frame_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    global CSRC
    ap = argparse.ArgumentParser()
    ap.add_argument("kernels", nargs="*")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--csrc", type=Path, default=CSRC)
    args = ap.parse_args()
    CSRC = args.csrc.resolve()
    kernels = args.kernels or [g.kernel for g in chip_smoke.GAMES]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, "; sources:", CSRC)
    libs = build_all(kernels, args.variant)
    stream = torch.cuda.current_stream().cuda_stream
    for g in chip_smoke.GAMES:
        if g.kernel not in kernels:
            continue
        cfg = g.module.default_config("cuda")
        consts = g.consts(cfg)
        host = (ctypes.c_float * len(consts))(*consts)
        h, w = g.module.HEIGHT, g.module.WIDTH
        tables = obs.warp_tables(h, w, chip_smoke.WARP, "cuda")
        s1, s2 = g.states(cfg, max(ENVS), 1)
        p1, p2 = g.prep(cfg, s1), g.prep(cfg, s2)
        preps = (p1[:, None].contiguous(), torch.stack([p1, p2], 1))
        for (kernel, variant), lib in libs.items():
            if kernel != g.kernel:
                continue
            warp = VARIANTS[kernel, variant][0] == "warp"
            fn = getattr(ctypes.CDLL(str(lib)),
                         kernel + ("_warp" if warp else ""))
            fn.argtypes = (render_cuda._WARP_ARGS if warp
                           else render_cuda._FRAME_ARGS)
            fn.restype = ctypes.c_int
            cells = []
            for fused in ((1,) if warp else (0, 1)):
                for n in ENVS:
                    prep = preps[fused][:n]
                    if warp:
                        s = tables.size
                        out = torch.empty((n, s, s), dtype=torch.uint8,
                                          device="cuda")
                        args = (prep.data_ptr(), out.data_ptr(), n, host,
                                len(consts), tables.wy.data_ptr(),
                                tables.wx.data_ptr(), tables.taps.data_ptr(),
                                s, prep.device.index, stream)
                    else:
                        out = torch.empty((n, h, w), dtype=torch.uint8,
                                          device="cuda")
                        args = (prep.data_ptr(), out.data_ptr(), n, fused,
                                host, len(consts), prep.device.index,
                                stream)

                    def call():
                        rc = fn(*args)
                        chip_smoke.check(rc == 0, f"{kernel} {variant}: "
                                                  f"CUDA error {rc}")

                    symbol = kernel + ("_warp" if warp else "") + "_kernel"
                    us = chip_smoke.kernel_ms(call, symbol, 50) * 1e3
                    want = (g.ops.frame_warp_plain(prep, consts, tables)
                            if warp else g.ops.frame_plain(prep, consts))
                    exact = torch.equal(out, want)
                    form = "warp" if warp else ("single", "fused")[fused]
                    cells.append(f"{form} N={n} {us:.2f} us"
                                 f"{' exact' if exact else ''}")
            print(f"{kernel} {variant}: " + "; ".join(cells), flush=True)
    for (kernel, variant), lib in libs.items():
        if variant in ("as is", "warp as is"):
            print(f"{kernel} {variant}, I2F in SASS: {i2f_counts(lib)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
