"""The port's Breakout frame (the CUDA kernel's plain version, which CPU
tensors take) and warp against the JAX package: within 1 grey level of
``luma2d(breakout.render)`` and of the Pallas kernel in interpret mode,
the tolerance of tests/test_render_pallas.py; and the geometry that the
CUDA kernel (csrc/breakout_frame.cu) composes in whole words."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
import toybox_tpu.games.breakout as jbk
from toybox_tpu.core.actions import ale_to_input
from toybox_tpu.games.common import luma2d as j_luma2d
from toybox_tpu.ops import render_pallas as rp
from toybox_tpu.ops.obs import warp_frame2d
from toybox_tpu_torch.games import breakout as tbk
from toybox_tpu_torch.games.common import luma2d as t_luma2d
from toybox_tpu_torch.ops import obs as tobs
from toybox_tpu_torch.ops import render_cuda

N = 4


def _to_torch(js) -> tbk.State:
    out = {}
    for f in tbk.FIELDS:
        a = np.asarray(getattr(js, f))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[f] = torch.tensor(a)
    return tbk.State(**out)


def _states(seed0, steps, action):
    """Two consecutive state batches after a rollout: balls in play, some
    bricks knocked out, one env with the ball waiting to be served."""
    cfg = jbk.default_config()
    s = jax.vmap(lambda x: jbk.new_game(cfg, seed=x))(
        jnp.arange(seed0, seed0 + N, dtype=jnp.uint32))
    step = jax.jit(jax.vmap(jbk.step, in_axes=(None, 0, 0)))
    fire = ale_to_input(jnp.full(N, 1, jnp.int32))
    move = ale_to_input(jnp.full(N, action, jnp.int32))
    s = step(cfg, s, fire)
    for _ in range(steps):
        s = step(cfg, s, move)
    alive = np.asarray(s.brick_alive).copy()
    alive[:, 10:30] = False
    alive[1, 60:100:3] = False
    s = s.replace(brick_alive=jnp.asarray(alive),
                  reset=jnp.asarray([False, False, False, True]))
    s2 = step(cfg, s, move)
    return cfg, s, s2


def _jax_frames(cfg, s):
    return np.asarray(jax.vmap(lambda x: j_luma2d(jbk.render(cfg, x)))(s))


def _max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
               .max())


@pytest.mark.parametrize("seed0,steps,action", [(0, 30, 3), (5, 70, 4)])
def test_single_frame_matches_jax_render_and_pallas(seed0, steps, action):
    cfg, s, _ = _states(seed0, steps, action)
    tcfg = tbk.default_config("cpu")
    ts = _to_torch(s)
    port = render_cuda.make_breakout_gray_renderer(tcfg)(ts).numpy()
    assert port.shape == (N, 160, 240) and port.dtype == np.uint8
    assert _max_diff(port, _jax_frames(cfg, s)) <= 1
    pallas = rp.make_breakout_gray_renderer(cfg, interpret=True)(s)
    assert _max_diff(port, pallas) <= 1
    # the port's own RGBA render agrees with its frame kernel's plain form
    assert _max_diff(port, t_luma2d(tbk.render(tcfg, ts)).numpy()) <= 1


@pytest.mark.parametrize("seed0,steps,action", [(0, 30, 3), (9, 50, 4)])
def test_fused_frame_matches_max_of_jax_renders_and_pallas(seed0, steps,
                                                           action):
    cfg, s1, s2 = _states(seed0, steps, action)
    tcfg = tbk.default_config("cpu")
    render2 = render_cuda.make_breakout_gray_maxpool_renderer(tcfg)
    port = render2(_to_torch(s1), _to_torch(s2)).numpy()
    want = np.maximum(_jax_frames(cfg, s1), _jax_frames(cfg, s2))
    assert _max_diff(port, want) <= 1
    pallas = rp.make_breakout_gray_maxpool_renderer(cfg, interpret=True)(
        s1, s2)
    assert _max_diff(port, pallas) <= 1


def test_moved_paddle_y_follows_state_like_render():
    """The paddle is drawn at state.paddle_y, as breakout.render draws it
    (the Pallas prep fixes it at 143)."""
    cfg, s, s2 = _states(2, 20, 3)
    py = np.asarray(s.paddle_y).copy()
    py[0] = 120.0
    s = s.replace(paddle_y=jnp.asarray(py))
    s2 = s2.replace(paddle_y=jnp.asarray(py))
    tcfg = tbk.default_config("cpu")
    port = render_cuda.make_breakout_gray_renderer(tcfg)(_to_torch(s))
    jf = _jax_frames(cfg, s)
    assert _max_diff(port.numpy(), jf) <= 1
    assert (jf[0, 120:124] != jf[1, 120:124]).any()   # the paddle moved
    fused = render_cuda.make_breakout_gray_maxpool_renderer(tcfg)(
        _to_torch(s), _to_torch(s2)).numpy()
    assert _max_diff(fused, np.maximum(jf, _jax_frames(cfg, s2))) <= 1


def test_warp_matches_jax_resize():
    r = np.random.default_rng(0)
    frames = r.integers(0, 255, (3, 160, 240), np.uint8)
    want = np.asarray(warp_frame2d(jnp.asarray(frames), 84))
    warp = tobs.make_warp(160, 240, 84, device="cpu")
    got = warp(torch.as_tensor(frames)).numpy()
    assert got.shape == (3, 84, 84) and got.dtype == np.uint8
    assert _max_diff(got, want) <= 1


def test_bilinear_matrix_matches_jax():
    for out, inp in ((84, 160), (84, 240)):
        np.testing.assert_array_equal(tobs.bilinear_matrix(out, inp),
                                      rp._bilinear_matrix(out, inp))


def test_wrapper_checks_inputs():
    lumas = (0.0, 144.0, 100.0, 100.0)
    with pytest.raises(ValueError):
        render_cuda.render_frames(torch.zeros(2, 3, render_cuda.PREP), lumas)
    with pytest.raises(TypeError):
        render_cuda.render_frames(
            torch.zeros(2, 1, render_cuda.PREP, dtype=torch.float64), lumas)
    before = dict(render_cuda.LAUNCHES)
    render_cuda.render_frames(torch.zeros(2, 1, render_cuda.PREP), lumas)
    assert render_cuda.LAUNCHES == before      # the plain version, no launch


def test_static_frame_lies_on_whole_words():
    """csrc/breakout_frame.cu composes the walls and the brick band in
    4-pixel words, one byte a word, and stores 16-pixel chunks: every x
    boundary of the static frame lies on a multiple of 4, and the width on
    a multiple of 16. The kernel's own constants, read from its source,
    agree with the engine's; and the plain frame with every sprite hidden
    is constant over each aligned word."""
    band_x0 = 12
    band_x1 = band_x0 + tbk.N_COLS * tbk.BRICK_CELL_W
    assert (tbk.LEFT_WALL, tbk.RIGHT_WALL) == (band_x0, band_x1)
    for x in (tbk.LEFT_WALL, tbk.RIGHT_WALL, band_x0, band_x1,
              tbk.BRICK_CELL_W):
        assert x % 4 == 0
    assert tbk.WIDTH % 16 == 0 and (tbk.HEIGHT * tbk.WIDTH) % 16 == 0
    src = (render_cuda.CSRC / "breakout_frame.cu").read_text()
    k = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);",
                                             src)}
    assert (k["kH"], k["kW"], k["kPrep"], k["kSprite0"]) == (
        tbk.HEIGHT, tbk.WIDTH, render_cuda.PREP, render_cuda.SPRITE0)
    assert (k["kGridRows"], k["kGridCols"], k["kCellW"], k["kCellH"]) == (
        tbk.MAX_RENDER_ROWS, tbk.N_COLS, tbk.BRICK_CELL_W, tbk.BRICK_CELL_H)
    assert (k["kBandY0"], k["kBandX0"], k["kWallY0"], k["kWallY1"]) == (
        tbk.BRICK_BAND_Y0, band_x0, tbk.TOP_WALL, tbk.TOP_WALL + 3)

    r = np.random.default_rng(1)
    prep = torch.zeros((3, render_cuda.PREP))
    grid = r.uniform(-1.0, 300.0, (3, render_cuda.SPRITE0))
    grid[r.random(grid.shape) < 0.3] = -1.0
    prep[:, :render_cuda.SPRITE0] = torch.as_tensor(grid)
    lumas = render_cuda.breakout_lumas(tbk.default_config("cpu"))
    frames = render_cuda.frame_plain(prep[:, None], lumas).numpy()
    words = frames.reshape(3, tbk.HEIGHT, tbk.WIDTH // 4, 4)
    assert (words == words[..., :1]).all()
    assert len(np.unique(frames)) > 10            # walls, bricks, background
