"""The port's intervention API against the JAX package's: the edits of
tests/test_interventions_{breakout,space_invaders,amidar}.py, made through
each package's facade, give the same state and config JSON (and the same
state after a short action script from there); ``batched_get`` and
``batched_set`` give the same values and states as the JAX ones on the
same [N, ...] states, with and without an env mask."""

import json
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu
import toybox_tpu.interventions.amidar as j_am
import toybox_tpu.interventions.base as j_base
import toybox_tpu.interventions.breakout as j_bk
import toybox_tpu.interventions.core as j_core
import toybox_tpu.interventions.space_invaders as j_si
import toybox_tpu_torch
import toybox_tpu_torch.interventions.amidar as t_am
import toybox_tpu_torch.interventions.base as t_base
import toybox_tpu_torch.interventions.breakout as t_bk
import toybox_tpu_torch.interventions.core as t_core
import toybox_tpu_torch.interventions.space_invaders as t_si
from tests.test_torch_codecs import (assert_fields_equal,  # noqa: F401
                                     jax_state_to_port, one_torch_thread)
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu.interventions.batched import batched_get as j_get
from toybox_tpu.interventions.batched import batched_set as j_set
from toybox_tpu_torch.games import get_game as t_get_game
from toybox_tpu_torch.interventions import get_intervener, state_from_toybox
from toybox_tpu_torch.interventions.batched import batched_get as t_get
from toybox_tpu_torch.interventions.batched import batched_set as t_set

JAX = types.SimpleNamespace(pkg=toybox_tpu, bk=j_bk, si=j_si, am=j_am,
                            core=j_core, base=j_base, kw={})
PORT = types.SimpleNamespace(pkg=toybox_tpu_torch, bk=t_bk, si=t_si,
                             am=t_am, core=t_core, base=t_base,
                             kw={"device": "cpu"})
SCRIPT_FRAMES = 40


# -- Breakout (tests/test_interventions_breakout.py) ------------------------

def bk_lives(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.game.lives = 1
        return iv.dirty_state, iv.dirty_config


def bk_remove_brick(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.game.bricks[0].alive = False
        return iv.num_bricks_remaining()


def bk_channel(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.add_channel(0)
        out = [iv.find_channel()[0], iv.channel_count()]
    out.append(tb.rstate.breakout_channel_count())
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.add_channel(7)
        iv.fill_column(0)
        out.append(iv.num_bricks_remaining())
    return out + [tb.rstate.breakout_bricks_remaining()]


def bk_brick_color(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.game.bricks[50].color.g = 77


def bk_multiball(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.game.balls.append(iv.game.balls[0])
        return len(iv.get_ball_position())


def bk_ball_moves(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        pos = iv.get_ball_position()
        pos.x, pos.y = pos.x + 1, pos.y + 1
        vel = iv.get_ball_velocity()
        vel.x, vel.y = vel.x + 1, vel.y + 1


def bk_paddle(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.get_paddle_position().x += 10
        iv.game.paddle.velocity = m.core.Vec2D.decode(
            iv, {"x": 3.0, "y": 5.0}, m.core.Vec2D)
        iv.game.paddle_speed = 10


def bk_properties(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        g = iv.game
        m.core.get_property(g, "bricks[0].color.r", setval=72)
        m.core.get_property(g, "bricks[107].points", setval=0)
        m.core.get_property(g, "paddle_speed", setval=100.0)
        m.core.get_property(g, "bricks[1]", setval=m.bk.Brick.decode(
            iv, g.bricks[2].encode(), m.bk.Brick))


def bk_partial_config(m, tb, tmp):
    f = tmp / "partial.json"
    f.write_text(json.dumps({"start_lives": 2}))
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.set_partial_config(str(f))
        return iv.dirty_config


def bk_clear_board(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        iv.clear_board()
        iv.game.bricks[100].alive = True


def bk_last_brick(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb) as iv:
        for i, brick in enumerate(iv.game.bricks):
            brick.alive = (i == 50)


def bk_eq_modes(m, tb, tmp):
    with m.bk.BreakoutIntervention(tb, eq_mode=m.base.SetEq) as iv:
        s1 = m.bk.Breakout.decode(iv, iv.game.encode(), m.bk.Breakout)
        iv.game.bricks[50].color.g = 99
        s2 = m.bk.Breakout.decode(iv, iv.game.encode(), m.bk.Breakout)
        return sorted(map(str, (s1.eq_mode(s1) == s2.eq_mode(s2)).differs))


# -- Space Invaders (tests/test_interventions_space_invaders.py) -----------

def si_lives(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        iv.game.lives = 1


def si_jitter(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        iv.set_jitter(0.9)
    with m.si.SpaceInvadersIntervention(tb) as iv:
        return iv.get_jitter()


def si_mothership(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        iv.remove_mothership(0)


def si_enemy(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        iv.game.enemies[0].alive = False
        iv.game.enemies[7].x += 3
        iv.get_player().x = 100


def si_erode_shield(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        shield = iv.game.shields[0]
        for ri, row in enumerate(shield.data):
            if ri < len(shield.data) // 2:
                for px in row:
                    px.a = 0


def si_no_shields(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        for shield in iv.game.shields:
            for row in shield.data:
                for px in row:
                    px.a = 0
    return tb.rstate.space_invaders_shield_cell_count()


def si_round_trip(m, tb, tmp):
    with m.si.SpaceInvadersIntervention(tb) as iv:
        js = iv.game.encode()
        g2 = m.si.SpaceInvaders.decode(iv, js, m.si.SpaceInvaders)
        assert g2.encode() == js
        return js


# -- Amidar (tests/test_interventions_amidar.py) ----------------------------

def am_lives_jumps(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.game.lives = 1
        iv.game.jumps = 5


def am_paint(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_tile_tag(iv.get_tile_by_pos(tx=0, ty=0), m.am.Tile.Painted)
        iv.set_tile_tag(iv.get_tile_by_pos(tx=5, ty=0), m.am.Tile.Unpainted)


def am_remove_enemy(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.game.enemies.remove(iv.game.enemies[4])


def am_remove_all_enemies(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        enemies = iv.game.enemies
        while len(enemies) > 0:
            enemies.remove(enemies[0])
    return tb.rstate.amidar_num_enemies()


def am_add_enemy(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        enemies = iv.game.enemies
        enemy = m.am.Enemy.decode(iv, enemies[1].encode(), m.am.Enemy)
        nxt = max(e.ai.next or 0 for e in enemies) + 1
        iv.set_enemy_protocol(enemy, m.am.MovementAI.EnemyLookupAI,
                              next=nxt, default_route_index=3)
        enemies.append(enemy)


def _dir(m, iv):
    return m.core.Direction(iv, random.choice(m.core.Direction.directions))


def am_perimeter(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_enemy_protocol(iv.game.enemies[-1],
                              m.am.MovementAI.EnemyPerimeterAI,
                              start=m.am.TilePoint(iv, tx=0, ty=0))


def am_amidar_mvmt(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_enemy_protocol(
            iv.game.enemies[-1], "EnemyAmidarMvmt", vert=_dir(m, iv),
            horiz=_dir(m, iv), start_vert=_dir(m, iv),
            start_horiz=_dir(m, iv), start=m.am.TilePoint(iv, tx=0, ty=0))


def am_target_player(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_enemy_protocol(
            iv.game.enemies[-1], "EnemyTargetPlayer",
            start=m.am.TilePoint(iv, tx=0, ty=0), vision_distance=10,
            player_seen=None, start_dir=_dir(m, iv), dir=_dir(m, iv))


def am_random_mvmt(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        for e in iv.game.enemies:
            iv.set_enemy_protocol(
                e, "EnemyRandomMvmt", start=m.am.TilePoint(iv, tx=0, ty=0),
                start_dir=_dir(m, iv), dir=_dir(m, iv))


def am_modes(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_mode("jump")
    out = [tb.rstate.amidar_jump_mode()]
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_mode("regular")
        iv.set_mode("chase", set_time=40)
    return out + [tb.rstate.amidar_chase_mode()]


def am_random_start(m, tb, tmp):
    with m.am.AmidarIntervention(tb) as iv:
        iv.set_player_random_start()
        return (iv.player_tile().tag, iv.player_enemy_distances(),
                iv.player_on_painted(), iv.player_near_unpainted())


EDITS = {
    "breakout": [bk_lives, bk_remove_brick, bk_channel, bk_brick_color,
                 bk_multiball, bk_ball_moves, bk_paddle, bk_properties,
                 bk_partial_config, bk_clear_board, bk_last_brick,
                 bk_eq_modes],
    "space_invaders": [si_lives, si_jitter, si_mothership, si_enemy,
                       si_erode_shield, si_no_shields, si_round_trip],
    "amidar": [am_lives_jumps, am_paint, am_remove_enemy,
               am_remove_all_enemies, am_add_enemy, am_perimeter,
               am_amidar_mvmt, am_target_player, am_random_mvmt, am_modes,
               am_random_start],
}


def _edit_in_both(game, edit, tmp_path):
    """The edit through each package's facade: what it returned, the state
    and config JSON after it, and the state after SCRIPT_FRAMES frames."""
    out = []
    for m in (JAX, PORT):
        tb = m.pkg.Toybox(game, **m.kw)
        tb.apply_action(m.pkg.Input(button1=True))
        random.seed(7)
        got = edit(m, tb, tmp_path)
        after = [got, tb.to_state_json(), tb.config_to_json()]
        legal = tb.get_legal_action_set()
        for i in range(SCRIPT_FRAMES):
            tb.apply_ale_action(1 if i % 11 == 0 else
                                legal[(i * 7 + i // 5) % len(legal)])
        out.append(after + [tb.to_state_json()])
    return out


def _check(game, edit, tmp_path):
    (jgot, jst, jcfg, jend), (tgot, tst, tcfg, tend) = _edit_in_both(
        game, edit, tmp_path)
    assert tgot == jgot
    assert tst == jst
    assert tcfg == jcfg
    assert tend == jend


@pytest.mark.parametrize("edit", EDITS["breakout"], ids=lambda f: f.__name__)
def test_breakout_edits_match_jax(edit, tmp_path):
    _check("breakout", edit, tmp_path)


@pytest.mark.parametrize("edit", EDITS["space_invaders"],
                         ids=lambda f: f.__name__)
def test_space_invaders_edits_match_jax(edit, tmp_path):
    _check("space_invaders", edit, tmp_path)


@pytest.mark.parametrize("edit", EDITS["amidar"], ids=lambda f: f.__name__)
def test_amidar_edits_match_jax(edit, tmp_path):
    _check("amidar", edit, tmp_path)


def test_registry_and_state_from_toybox():
    tb = toybox_tpu_torch.Toybox("breakout", device="cpu")
    assert get_intervener("space_invaders") is t_si.SpaceInvadersIntervention
    game = state_from_toybox(tb)
    assert isinstance(game, t_bk.Breakout)
    assert game.encode()["bricks"] == tb.to_state_json()["bricks"]


# -- batched_get / batched_set ----------------------------------------------

BATCHED = {
    "breakout": [("bricks[5].alive", False), ("paddle.position.x", "xs"),
                 ("balls[0].velocity.y", -3.5), ("bricks[9].color", 12345),
                 ("lives", 1)],
    "space_invaders": [("enemies[3].alive", False), ("ship.x", "xs"),
                       ("ufo.appearance_counter", 0), ("score", 7)],
    "amidar": [("enemies[2].position.x", "xs"), ("jumps", 0),
               ("enemies[0].caught", True), ("player.position.y", 320)],
}


@pytest.mark.parametrize("game", sorted(BATCHED))
def test_batched_get_and_set_match_jax(game):
    n = 6
    jmod, tmod = j_get_game(game), t_get_game(game)
    jcfg = jmod.default_config()
    js = jax.vmap(lambda s: jmod.new_game(jcfg, seed=s))(
        jnp.arange(n, dtype=jnp.uint32))
    ts = jax_state_to_port(tmod, js, batched=True)
    mask = np.array([True, False, True, True, False, False])
    for path, value in BATCHED[game]:
        if value == "xs":
            value = np.arange(n, dtype=np.int32) * 16 + 40
        for env_mask in (None, mask):
            js2 = j_set(js, game, path, value, env_mask=env_mask)
            ts2 = t_set(ts, game, path, value if np.isscalar(value)
                        else torch.as_tensor(value),
                        env_mask=None if env_mask is None
                        else torch.as_tensor(env_mask))
            assert_fields_equal(tmod, js2, ts2, batched=True,
                                where=f"after {path} (mask {env_mask})")
            got = t_get(ts2, game, path)
            want = np.asarray(j_get(js2, game, path))
            np.testing.assert_array_equal(
                got.numpy(), want.astype(np.int64) if want.dtype == np.uint32
                else want)
        assert_fields_equal(tmod, js, ts, batched=True, where="(unchanged)")
    with pytest.raises(KeyError):
        t_get(ts, game, "no.such[1].path")
