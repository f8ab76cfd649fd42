"""The in-kernel warp (``warp_to=84``) of the three fused frame kernels: the
plain version, which CPU tensors take, against the JAX Pallas kernels in
interpret mode and against the port's own fused frame + matmul warp.

Tolerance: 1 grey level, with the count of differing pixels reported, as
tests/test_render_pallas.py allows the Pallas warp against the XLA one:
the matmuls sum in another order than the banded sums, and a sum that
lands next to a half-integer can round the other way. The banded sum
itself is exactly the full ordered sum.
"""

import re
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.amidar as jam
import toybox_tpu.games.breakout as jbk
import toybox_tpu.games.space_invaders as jsi
from toybox_tpu.core.actions import ale_to_input
from toybox_tpu.ops import render_pallas as rp
from toybox_tpu_torch.games import amidar as tam
from toybox_tpu_torch.games import breakout as tbk
from toybox_tpu_torch.games import space_invaders as tsi
from toybox_tpu_torch.ops import obs as tobs
from toybox_tpu_torch.ops import render_amidar, render_cuda, render_si

N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch ops here are small: one intra-op thread does them as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# game: (JAX module, port module, random frames before the pair, Pallas
# maxpool factory, port maxpool factory)
GAMES = {
    "breakout": (jbk, tbk, 60, rp.make_breakout_gray_maxpool_renderer,
                 render_cuda.make_breakout_gray_maxpool_renderer),
    "space_invaders": (jsi, tsi, 200, rp.make_si_gray_maxpool_renderer,
                       render_si.make_si_gray_maxpool_renderer),
    "amidar": (jam, tam, 150, rp.make_amidar_gray_maxpool_renderer,
               render_amidar.make_amidar_gray_maxpool_renderer),
}


def _to_torch(tmod, js):
    out = {}
    for f in tmod.FIELDS:
        a = np.asarray(getattr(js, f))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[f] = torch.tensor(a)
    return tmod.State(**out)


def _states(jmod, frames, seed):
    """Two consecutive state batches after random play from a seed (FIRE
    every 10 frames)."""
    cfg = jmod.default_config()
    r = np.random.default_rng(seed)
    s = jax.vmap(lambda x: jmod.new_game(cfg, seed=x))(
        jnp.arange(seed, seed + N, dtype=jnp.uint32))
    step = jax.jit(jax.vmap(jmod.step, in_axes=(None, 0, 0)))
    legal = np.asarray(jmod.LEGAL_ACTIONS)
    for i in range(frames + 1):
        a = np.full(N, 1) if i % 10 == 0 else r.choice(legal, N)
        s1, s = s, step(cfg, s, ale_to_input(jnp.asarray(a, jnp.int32)))
    return cfg, s1, s


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), int((d > 0).sum())


@pytest.mark.parametrize("game", sorted(GAMES))
def test_warp_plain_matches_pallas_and_out_of_kernel_warp(game):
    jmod, tmod, frames, pallas2, port2 = GAMES[game]
    cfg, s1, s2 = _states(jmod, frames, seed=3)
    tcfg = tmod.default_config("cpu")
    t1, t2 = _to_torch(tmod, s1), _to_torch(tmod, s2)
    before = dict(render_cuda.LAUNCHES)
    got = port2(tcfg, warp_to=84)(t1, t2)
    assert render_cuda.LAUNCHES == before      # the plain version
    assert tuple(got.shape) == (N, 84, 84) and got.dtype == torch.uint8
    want = pallas2(cfg, interpret=True, warp_to=84)(s1, s2)
    worst, count = _diff(got, want)
    print(f"{game}: vs Pallas warp_to=84, max diff {worst}, {count} of "
          f"{got.numel()} pixels differ")
    assert worst <= 1
    # the port's out-of-kernel path: fused frame, then two matmuls
    warp = tobs.make_warp(tmod.HEIGHT, tmod.WIDTH, 84, "cpu")
    worst, count = _diff(got, warp(port2(tcfg)(t1, t2)))
    print(f"{game}: vs fused frame + matmul warp, max diff {worst}, "
          f"{count} pixels differ")
    assert worst <= 1
    assert float(got.float().std()) > 1.0      # not a blank frame


def _full_ordered_sum(x, w, dim):
    """out[.., o, ..] = sum over every index i in increasing order of
    w[o, i] * x[.., i, ..], zero weights included."""
    acc = torch.zeros((), dtype=torch.float32)
    for i in range(w.shape[1]):
        if dim == -2:
            acc = acc + w[:, i][:, None] * x[..., i, None, :]
        else:
            acc = acc + x[..., i, None] * w[:, i]
    return acc


@pytest.mark.parametrize("h,w", [(160, 240), (210, 320), (250, 160)])
def test_banded_sum_equals_full_ordered_sum(h, w):
    tables = tobs.warp_tables(h, w, 84, "cpu")
    r = np.random.default_rng(h + w)
    img = torch.as_tensor(r.integers(0, 256, (2, h, w)),
                          dtype=torch.float32)
    t = tobs._band_sum(img, tables.wy, tables.taps[0], -2)
    assert torch.equal(t, _full_ordered_sum(img, tables.wy, -2))
    out = tobs._band_sum(t, tables.wx, tables.taps[1], -1)
    assert torch.equal(out, _full_ordered_sum(t, tables.wx, -1))
    # every weight outside a row's band is zero, none inside it is
    for m, taps in ((tables.wy, tables.taps[0]), (tables.wx, tables.taps[1])):
        cols = torch.arange(m.shape[1])
        inside = ((cols >= taps[:, :1]) & (cols < taps[:, :1] + taps[:, 1:]))
        assert bool((m[~inside] == 0).all()) and bool((m[inside] > 0).all())
    assert tables.taps[0, :, 1].max() <= 6 and tables.taps[1, :, 1].max() <= 8


def test_warp_wrapper_checks_inputs():
    tables = tobs.warp_tables(render_cuda.H, render_cuda.W, 84, "cpu")
    lumas = (0.0,) * 4
    before = dict(render_cuda.LAUNCHES)
    one = torch.zeros(2, 1, render_cuda.PREP)
    with pytest.raises(ValueError, match="two frames"):
        render_cuda.render_frames(one, lumas, tables)
    wrong = tobs.warp_tables(210, 320, 84, "cpu")
    with pytest.raises(ValueError, match="warp table"):
        render_cuda.render_frames(torch.zeros(2, 2, render_cuda.PREP),
                                  lumas, wrong)
    out = render_cuda.render_frames(torch.zeros(2, 2, render_cuda.PREP),
                                    lumas, tables)
    assert tuple(out.shape) == (2, 84, 84)
    assert render_cuda.LAUNCHES == before


# A stand-in for nvcc (as in tests/test_torch_render_si_amidar.py): it
# writes the "library" with the source's text, headers not expanded, and
# counts its runs.
_FAKE_NVCC = textwrap.dedent("""\
    import os, pathlib, sys
    args = sys.argv[1:]
    out, src = pathlib.Path(args[args.index("-o") + 1]), pathlib.Path(args[-1])
    runs = pathlib.Path(os.environ["FAKE_NVCC_RUNS"])
    runs.write_text(runs.read_text() + src.name + "\\n")
    out.write_bytes(src.read_bytes())
""")


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    (csrc / "inc").mkdir(parents=True)
    (csrc / "k.cu").write_text('#include <cstdint>\n#include "inc/a.cuh"\n')
    (csrc / "inc" / "a.cuh").write_text('#pragma once\n#include "../b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    (csrc / "unused.cuh").write_text("// not included\n")
    script = tmp_path / "nvcc.py"
    script.write_text(_FAKE_NVCC)
    runs = tmp_path / "runs"
    runs.write_text("")
    monkeypatch.setenv("FAKE_NVCC_RUNS", str(runs))
    monkeypatch.setattr(render_cuda, "_nvcc",
                        lambda: [sys.executable, str(script)])
    monkeypatch.setattr(render_cuda, "CSRC", csrc)
    monkeypatch.setattr(render_cuda, "BUILD_DIR", tmp_path / "kernels")

    src = csrc / "k.cu"
    assert [p.relative_to(csrc).as_posix() for p in
            render_cuda._sources(src)] == ["k.cu", "inc/a.cuh",
                                           "inc/../b.cuh"]
    first = render_cuda.build()["k"][0]
    (csrc / "unused.cuh").write_text("// edited\n")
    assert render_cuda._library_path(src) == first
    render_cuda.build()
    assert runs.read_text() == "k.cu\n"          # cached: not rebuilt
    keys = {first}
    for header in ("b.cuh", "inc/a.cuh"):
        (csrc / header).write_text((csrc / header).read_text() + "// x\n")
        key = render_cuda._library_path(src)
        assert key not in keys, f"editing {header} kept the build key"
        keys.add(key)
        assert render_cuda.build()["k"][0] == key
    assert runs.read_text() == "k.cu\n" * 3     # each edit rebuilt it


def test_frame_sources_include_the_warp_header():
    """Every frame kernel's build key covers the warp header and the chunk
    header (Breakout's frames are composed in chunks and words too)."""
    for name in ("breakout_frame", "si_frame", "amidar_frame"):
        names = [p.name for p in
                 render_cuda._sources(render_cuda.CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", "chunk16.cuh", "warp84.cuh"]


# (min, max, sum) of the taps of the rows of bilinear_matrix(84, n), for
# every frame height and width of the three games
TAPS = {160: (3, 4, 318), 210: (4, 5, 418), 240: (4, 6, 478),
        250: (4, 6, 498), 320: (6, 8, 636)}


@pytest.mark.parametrize("n", sorted(TAPS))
def test_bands_fit_the_warp_stage_sweep(n):
    """What csrc/warp84.cuh's sweep assumes of the warp tables (its set-up
    checks it on the card and stops the kernel otherwise): each input line
    lies in the bands of one or two output lines, never three; the bands'
    first lines never decrease and their last lines increase; band i + 2
    starts after band i ends; the bands cover the frame."""
    taps = tobs.tap_ranges(tobs.bilinear_matrix(84, n))
    first, count = taps[:, 0], taps[:, 1]
    last = first + count - 1
    cover = np.zeros(n, int)
    for f, c in taps:
        cover[f:f + c] += 1
    assert cover.min() == 1 and cover.max() == 2
    assert (np.diff(first) >= 0).all() and (np.diff(last) > 0).all()
    assert (first[2:] > last[:-2]).all()
    assert first[0] == 0 and last[-1] == n - 1
    assert (int(count.min()), int(count.max()), int(count.sum())) == TAPS[n]


@pytest.mark.parametrize("name,tmod", [("breakout_frame", tbk),
                                       ("si_frame", tsi),
                                       ("amidar_frame", tam)])
def test_warp_tap_bounds_of_each_kernel(name, tmod):
    """Each kernel's frame size and its warp stage's tap bounds (kWarpKY
    for a Wy row, kWarpKX for a Wx row, read from its source) equal the
    game's frame and the most taps of its tables: no more (the padded taps
    cost time), no fewer (the set-up would stop the kernel)."""
    src = (render_cuda.CSRC / f"{name}.cu").read_text()
    k = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);",
                                             src)}
    assert (k["kH"], k["kW"]) == (tmod.HEIGHT, tmod.WIDTH)
    assert k["kWarpKY"] == TAPS[tmod.HEIGHT][1]
    assert k["kWarpKX"] == TAPS[tmod.WIDTH][1]
    tables = tobs.warp_tables(tmod.HEIGHT, tmod.WIDTH, 84, "cpu")
    assert int(tables.taps[0, :, 1].max()) == k["kWarpKY"]
    assert int(tables.taps[1, :, 1].max()) == k["kWarpKX"]
