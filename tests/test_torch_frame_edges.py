"""The port's Breakout, Space Invaders and Amidar frames (each CUDA
kernel's plain version, which CPU tensors take) against
``luma2d(<game>.render)`` of the JAX package on doctored states at the
frames' edges, single and fused: sprites straddling each frame edge and
past it, the Breakout paddle over the walls and moved in y, balls on
fractional edges and far off the frame, all bricks gone or present, the
SI formation pushed past the edges, lasers over the ship and the shields,
half-eroded shields, Amidar sprites overlapping at the board's corners,
hidden sprites. The states are chip_smoke.py's edge cases (its phase 3
holds the kernels to the plain versions on them on the card), built here
in JAX from the same numpy edits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.amidar as jam
import toybox_tpu.games.breakout as jbk
import toybox_tpu.games.space_invaders as jsi
from toybox_tpu.core.actions import ale_to_input
from toybox_tpu.games.common import luma2d as j_luma2d
from toybox_tpu_torch.games import amidar as tam
from toybox_tpu_torch.games import breakout as tbk
from toybox_tpu_torch.games import space_invaders as tsi
from toybox_tpu_torch.ops import render_amidar, render_cuda, render_si

from chip_smoke import (amidar_edge_fields, breakout_edge_fields,
                        si_edge_fields)

N = 8          # every Breakout and SI case once, every Amidar case at least
               # once

GAMES = {
    "breakout": (jbk, tbk, breakout_edge_fields,
                 render_cuda.make_breakout_gray_renderer,
                 render_cuda.make_breakout_gray_maxpool_renderer),
    "space_invaders": (jsi, tsi, si_edge_fields,
                       render_si.make_si_gray_renderer,
                       render_si.make_si_gray_maxpool_renderer),
    "amidar": (jam, tam, amidar_edge_fields,
               render_amidar.make_amidar_gray_renderer,
               render_amidar.make_amidar_gray_maxpool_renderer),
}


def _to_torch(tmod, js):
    """A batched JAX state -> the port's State (u32 words as int64)."""
    out = {}
    for f in tmod.FIELDS:
        a = np.asarray(getattr(js, f))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[f] = torch.tensor(a)
    return tmod.State(**out)


def _edges(tmod, edit, s, shift):
    fields = {f: np.asarray(getattr(s, f)) for f in tmod.FIELDS}
    return s.replace(**{f: jnp.asarray(v)
                        for f, v in edit(fields, shift).items()})


def _states(game):
    """Two consecutive states after 40 frames of random play, each with
    the edge cases (the second frame's cases shifted by one env)."""
    jmod, tmod, edit, _, _ = GAMES[game]
    cfg = jmod.default_config()
    s = jax.vmap(lambda x: jmod.new_game(cfg, seed=x))(
        jnp.arange(N, dtype=jnp.uint32))
    step = jax.jit(jax.vmap(jmod.step, in_axes=(None, 0, 0)))
    r = np.random.default_rng(0)
    legal = np.asarray(jmod.LEGAL_ACTIONS)
    for i in range(40):
        a = np.where(i % 5 == 0, 1, r.choice(legal, N))
        s = step(cfg, s, ale_to_input(jnp.asarray(a, jnp.int32)))
    s2 = step(cfg, s, ale_to_input(jnp.ones(N, jnp.int32)))
    return cfg, _edges(tmod, edit, s, 0), _edges(tmod, edit, s2, 1)


def _jax_frames(jmod, cfg, s):
    return np.asarray(jax.vmap(lambda x: j_luma2d(jmod.render(cfg, x)))(s))


@pytest.mark.parametrize("fused", [False, True], ids=["single", "fused"])
@pytest.mark.parametrize("game", sorted(GAMES))
def test_plain_frames_match_jax_render_at_the_edges(game, fused):
    jmod, tmod, _, port1, port2 = GAMES[game]
    cfg, s1, s2 = _states(game)
    tcfg = tmod.default_config("cpu")
    t1 = _to_torch(tmod, s1)
    if fused:
        got = port2(tcfg)(t1, _to_torch(tmod, s2)).numpy()
        want = np.maximum(_jax_frames(jmod, cfg, s1),
                          _jax_frames(jmod, cfg, s2))
    else:
        got = port1(tcfg)(t1).numpy()
        want = _jax_frames(jmod, cfg, s1)
    assert got.shape == (N, tmod.HEIGHT, tmod.WIDTH)
    np.testing.assert_array_equal(got, want)


CONSTS = {"breakout": render_cuda.breakout_lumas,
          "space_invaders": render_si.si_consts,
          "amidar": render_amidar.amidar_consts}


@pytest.mark.parametrize("game", sorted(GAMES))
def test_edge_cases_reach_every_frame_edge(game):
    """The doctored states draw sprites on the frame's first and last rows
    and columns: the cases are not clipped away. Breakout's walls reach
    three edges by themselves, so there the paddle's and balls' luma must
    reach all four."""
    _, tmod, _, port1, _ = GAMES[game]
    _, s1, _ = _states(game)
    tcfg = tmod.default_config("cpu")
    consts = CONSTS[game](tcfg)
    frames = port1(tcfg)(_to_torch(tmod, s1)).numpy()
    lit = frames != int(consts[0])
    if game == "breakout":              # (bg, wall, paddle, ball) lumas
        assert int(consts[2]) == int(consts[3]) != int(consts[1])
        lit = frames == int(consts[2])
    for edge in (lit[:, 0, :], lit[:, -1, :], lit[:, :, 0], lit[:, :, -1]):
        assert edge.any()
